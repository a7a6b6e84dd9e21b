"""Multi-pod dry-run: trace every (architecture x input-shape x mesh) cell
with fake tensors on a fake-process-group ``DeviceMesh`` (nothing
allocated, no card, no network), and capture

* memory: this rank's arguments and the peak of its live storages over
  the step (:class:`MemoryTally`) - does the cell fit one card,
* cost: FLOPs per device (``FlopCounterMode``, whose formulas include the
  model kernels' own, ``kernels/flash_attention.py`` and
  ``kernels/ssd_scan.py``) and the bytes every dispatched op reads and
  writes,
* collectives: every collective the trace issues, its bytes and its
  group's size, on a ring model (:class:`CollectiveCounter`),

into one JSON per cell under ``--out``, in the reference's record schema.

Port of the JAX package's ``launch/dryrun.py``.  Where the reference
lowers and compiles against ``ShapeDtypeStruct``s, the port runs the
step once under a ``FakeTensorMode`` inside ``launch/mesh.py::fake_mesh``:
rank 0 of a 256- or 512-rank group whose collectives return at once.
The per-device numbers are this rank's, in the port's layout as it is:
weights stored sharded, activations this rank's batch shard, and each
model-axis rank computing its share of every block whose dim the model
axis divides (``partition.py``); the calls of blocks that repeat their
whole compute on every model rank instead are counted in the record's
``repeated_blocks``.

The trace's tensors are fake CUDA tensors where torch is built with CUDA.
A build without it cannot run autograd (or a slice) on a fake CUDA tensor,
as it has no CUDA device guard, so there the trace runs on ``meta``, whose
tensors take the kernels' custom ops just the same (:func:`trace_device`);
the numbers are the same.

Probes: the reference's XLA counts a loop body once, so it corrects its
totals with two unrolled probes.  The port's model is a list of layers and
every trace runs all of them (the reference's ``unroll`` has no twin), so
at one microbatch ``corrected`` equals the full trace for a family whose
layers are alike; the probes stay, and with them ``corrected`` and its
``_per_unit`` / ``_fixed`` split.

Run::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        h2o-danube-1.8b --shape train_4k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import partition
from repro_torch.configs import registry
from repro_torch.launch.mesh import PRODUCTION, fake_mesh
from repro_torch.models.layers import serving_copy
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import (init_state_shapes, make_state_axes,
                                       make_train_step)

#: One card's memory: ``torch.cuda.get_device_properties(0).total_memory``
#: of an NVIDIA H100 80GB HBM3 (power limit 700 W), read by
#: ``chip_smoke.py`` phase "dryrun".
HBM_BYTES = 85_017_493_504
#: Live-activation budget of the microbatch policy: the reference's, so
#: every cell takes the reference's microbatch count.
ACT_BUDGET = 6 * 2**30
#: The CUDA caching allocator's granularity: every block is a multiple.
ALLOC_ROUND = 512


def trace_device() -> str:
    """The fake tensors' device: ``"cuda"`` where torch is built with CUDA,
    else ``"meta"`` (see the module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


# ---------------------------------------------------------------------------
# Microbatch policy (grad accumulation keeps live activations under budget).
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a torch ``DeviceMesh`` or of a mesh-like
    object with ``axis_names`` and a ``shape`` dict (the reference's)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        if a in sizes:
            n *= sizes[a]
    return n


def _n_mamba(cfg) -> int:
    """A hybrid's Mamba-2 layers (granite-4.0-h); 0 for the others."""
    return cfg.block_types().count("mamba") if cfg.family == "hybrid" else 0


def _d_eff(cfg) -> int:
    """The widest activation a layer carries: d_model, the SSM layers'
    d_inner, the RG-LRU's width."""
    return max(cfg.d_model,
               cfg.d_inner if cfg.family == "ssm" or _n_mamba(cfg) else 0,
               cfg.rnn_width_ if cfg.family == "hybrid" else 0)


def choose_microbatches(cfg, spec, mesh) -> int:
    if spec.mode != "train":
        return 1
    dp = dp_size(mesh)
    B, S = spec.global_batch, spec.seq_len
    d_eff = _d_eff(cfg)
    # Per-layer live bytes per sequence row under per-layer remat: the saved
    # residual plus scan carries; alpha=2 safety.
    per_row_layer = S * d_eff * 2 * 2
    m = 1
    while True:
        rows_per_chip = max(1, (B // m) // dp)
        live = cfg.n_layers * rows_per_chip * per_row_layer
        if live <= ACT_BUDGET or (B // (2 * m)) % dp != 0 or B // (2 * m) < dp:
            return m
        m *= 2


# ---------------------------------------------------------------------------
# Collectives (ring model).
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"=\s*(?P<shape>[^=]*?)\s+(?P<op>all-reduce-start|all-gather-start|"
    r"all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute-start|"
    r"collective-permute)\(")
_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|s64|u64|s32|u32|s16|u16|s8|u8|pred|"
                       r"c64|c128)\[([0-9,]*)\]")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_PAIRS_RE = re.compile(r"source_target_pairs=\{\{")


def _shape_bytes(segment: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(segment):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def ring_bytes(op: str, result_bytes: float, group_size: int) -> tuple:
    """(operand bytes, ring-model wire bytes per device) of one collective
    of ``result_bytes`` over a group of ``group_size``."""
    n = max(group_size, 1)
    if op == "all-reduce":
        return result_bytes, 2.0 * result_bytes * (n - 1) / n
    if op == "all-gather":      # operand is the local shard
        return result_bytes / n, result_bytes * (n - 1) / n
    if op == "reduce-scatter":  # operand is the full tensor
        return result_bytes * n, result_bytes * (n - 1)
    if op == "all-to-all":
        return result_bytes, result_bytes * (n - 1) / n
    return result_bytes, float(result_bytes)  # collective-permute


class _Collectives:
    """The reference's per-device collective record, summed op by op."""

    def __init__(self):
        self.per_op: Dict[str, float] = {}
        self.wire = 0.0
        self.operand = 0.0
        self.count = 0

    def add(self, op: str, result_bytes: float, group_size: int):
        op_bytes, w = ring_bytes(op, result_bytes, group_size)
        self.per_op[op] = self.per_op.get(op, 0.0) + op_bytes
        self.wire += w
        self.operand += op_bytes
        self.count += 1

    def record(self) -> Dict[str, Any]:
        return {"per_op_operand_bytes": dict(self.per_op),
                "operand_bytes": self.operand, "ring_wire_bytes": self.wire,
                "n_collectives": self.count}


def parse_collectives(hlo_text: str) -> Dict[str, Any]:
    """Per-device collective byte accounting from partitioned HLO text (the
    reference's parser, kept for its records).

    Returns operand-byte sums per op kind and a ring-model wire-bytes
    estimate per device."""
    acc = _Collectives()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m is None:
            continue
        op = m.group("op").replace("-start", "")
        result_bytes = _shape_bytes(m.group("shape"))
        if result_bytes == 0:
            continue
        gi = _GROUPS_IOTA_RE.search(line)
        if gi:
            gsize = int(gi.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            gsize = len(gl.group(1).split(",")) if gl else 1
        acc.add(op, result_bytes, gsize)
    return acc.record()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


#: Collective ops a trace issues, by overload packet name: the reference's
#: op name, the group's size from the op's arguments, and its result from
#: its output.  The functional ones come from ``DTensor`` redistributes,
#: the in-place ``c10d`` ones from ``torch.distributed.all_reduce`` (the
#: model axis's partial sums, the flash-decode's combines, the moe balance
#: means, the step's loss) and ``all_gather`` (the model axis's
#: activation gathers).
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor":
        ("all-gather", lambda a: a[1], lambda out: out),
    "_c10d_functional::reduce_scatter_tensor":
        ("reduce-scatter", lambda a: a[2], lambda out: out),
    "_c10d_functional::all_reduce":
        ("all-reduce", lambda a: _group_size(a[2]), lambda out: out),
    "_c10d_functional::all_to_all_single":
        ("all-to-all", lambda a: _group_size(a[3]), lambda out: out),
    "c10d::allreduce_":
        ("all-reduce", lambda a: dist.ProcessGroup.unbox(a[1]).size(),
         lambda out: out[0]),
    "c10d::allgather_":
        ("all-gather", lambda a: dist.ProcessGroup.unbox(a[2]).size(),
         lambda out: out[0]),
}


def _has_dtensor(args, kwargs) -> bool:
    return any(partition.is_dtensor(x)
               for x in pytree.tree_leaves((args, kwargs or {})))


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched under it (:data:`_COLLECTIVE_OPS`;
    ``wait_tensor`` is not one) with its result bytes and its group's size,
    on the ring model of :func:`ring_bytes`.  An op on ``DTensor``s is left
    to ``DTensor`` to desugar first, so its collectives are seen."""

    def __init__(self):
        super().__init__()
        self.acc = _Collectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(args, kwargs):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        entry = _COLLECTIVE_OPS.get(func._overloadpacket._qualified_op_name)
        if entry is not None:
            op, size, result = entry
            nbytes = sum(_nbytes(t) for t in pytree.tree_leaves(result(out))
                         if isinstance(t, torch.Tensor))
            self.acc.add(op, nbytes, int(size(args)))
        return out

    def record(self) -> Dict[str, Any]:
        return self.acc.record()


# ---------------------------------------------------------------------------
# Memory and bytes: a tally of live storages.
# ---------------------------------------------------------------------------


def _storage_bytes(st) -> int:
    n = st.nbytes()
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class MemoryTally(TorchDispatchMode):
    """The live bytes of every storage created under it, each rounded up to
    :data:`ALLOC_ROUND` as the CUDA caching allocator rounds, on top of
    ``held`` (``{storage key: bytes}`` live from the start: the
    arguments); its peak; and the bytes every non-view op reads and writes
    (its tensor operands and results), the same "every op's operands"
    reading as XLA's ``bytes accessed`` and the same kind of upper bound.
    A storage leaves the tally when torch frees it.  Ops on ``DTensor``s
    are left to ``DTensor`` to desugar, so the local shards' storages are
    the ones counted."""

    def __init__(self, held: Optional[Dict[int, int]] = None):
        super().__init__()
        self.live: Dict[int, int] = dict(held or {})
        self.current = self.peak = sum(self.live.values())
        self.bytes_accessed = 0
        self.n_ops = 0

    def _free(self, key: int):
        self.current -= self.live.pop(key, 0)

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live (once); returns its bytes."""
        if partition.is_dtensor(t):
            t = t.to_local()
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return 0
        n = _storage_bytes(st)
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(args, kwargs):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in pytree.tree_leaves((args, kwargs or {}))
                if isinstance(t, torch.Tensor)) + sum(_nbytes(t)
                                                      for t in outs)
        return out


def _storages(tree) -> Dict[int, int]:
    """``{storage key: rounded bytes}`` of the tensors in ``tree`` (a
    ``DTensor``'s local shard), each storage once."""
    out = {}
    for t in pytree.tree_leaves(tree):
        if partition.is_dtensor(t):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = _storage_bytes(st)
    return out


# ---------------------------------------------------------------------------
# Cell construction.
# ---------------------------------------------------------------------------


def _probe_cfg(cfg, units: int):
    """A config with ``units`` pattern units of layers (for probes)."""
    if cfg.family == "hybrid":
        n = units * len(cfg.block_pattern)
    else:
        n = units
    kw = dict(n_layers=n)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = units
    return dataclasses.replace(cfg, **kw)


def n_units(cfg) -> float:
    if cfg.family == "hybrid":
        return cfg.n_layers / len(cfg.block_pattern)
    return float(cfg.n_layers)


def _make_rules(rules_kind: str, mesh, rows: int, extra_rules):
    if rules_kind == "fsdp":
        rules = partition.fsdp_rules(mesh, rows)
    elif rules_kind == "serve":
        rules = partition.serve_rules(mesh, rows)
    else:
        rules = partition.replicated_rules(mesh, rows)
    if extra_rules:
        rules = partition.Rules(mesh=mesh, table={**rules.table, **extra_rules})
    return rules


def build_cell(arch: str, shape: str, mesh, *, cfg=None,
               microbatches: Optional[int] = None, rules_kind="fsdp",
               remat=True, extra_rules: Optional[dict] = None,
               batch_rows: Optional[int] = None):
    """Returns ``(fn, args, shardings, donate, rules, mb)``: the cell's step,
    prefill or decode and its arguments as fake tensors on
    :func:`trace_device`, placed on ``mesh`` (``DTensor`` state, a global
    batch that the step shards), with the placements ``shardings`` names;
    ``donate`` the arguments updated in place.  Call it under a
    ``FakeTensorMode``, and ``fn`` under the same mode and
    ``partition.use_rules(rules)``.

    ``batch_rows`` overrides the global batch (the probes run the step on
    exactly one microbatch, so the M x (F + L x B) correction scales both
    activation and per-microbatch gradient collectives correctly)."""
    spec = registry.SHAPES[shape]
    cfg = cfg or registry.get_config(arch)
    dev = trace_device()
    model = Model(cfg, device=dev)
    rows = batch_rows or spec.global_batch
    rules = _make_rules(rules_kind, mesh, rows, extra_rules)
    mb = microbatches if microbatches is not None else \
        choose_microbatches(cfg, spec, mesh)

    in_axes = registry.input_logical_axes(arch, shape)
    inputs = {k: torch.empty((rows,) + v.shape[1:], dtype=v.dtype, device=dev)
              for k, v in registry.input_specs(arch, shape).items()}
    batch_sh = {k: rules.sharding(in_axes[k]) for k in inputs}
    param_axes = model.param_axes()
    params_sh = partition.param_shardings(rules, param_axes)

    with partition.use_rules(rules):
        if spec.mode == "train":
            opt = AdamW(learning_rate=cosine_schedule(3e-4, 100, 10_000))
            fn = make_train_step(model, opt, microbatches=mb, remat=remat,
                                 param_axes=param_axes)
            args = (init_state_shapes(model, opt), inputs)
            shardings = (partition.param_shardings(
                rules, make_state_axes(param_axes)), batch_sh)
            donate = (0,)
        elif spec.mode == "prefill":
            def fn(params, batch):
                batch = {k: partition.shard_batch(v) for k, v in batch.items()}
                return model.prefill(params, batch, max_seq=spec.seq_len)

            args = (partition.place(model.param_shapes(), params_sh,
                                    local=True), inputs)
            shardings = (params_sh, batch_sh)
            donate = ()
        else:  # decode
            params = model.param_shapes()
            if rules_kind == "serve":   # a server stores bf16 weights
                params = serving_copy(params)
            local_rows = max(1, rows // rules.size("batch"))
            cache = model.init_cache(local_rows, spec.seq_len)

            def fn(params, cache, token, pos):
                return model.decode_step(params, cache,
                                         partition.shard_batch(token), pos)

            args = (partition.place(params, params_sh, local=True), cache,
                    inputs["token"], spec.seq_len - 1)
            shardings = (params_sh, None, batch_sh["token"], None)
            donate = (1,)
    return fn, args, shardings, donate, rules, mb


# ---------------------------------------------------------------------------
# Trace + capture.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What one traced call saw: the arguments' and outputs' storages
    (``{key: bytes}``), the tally, the FLOP counter and the collectives."""
    args: Dict[int, int]
    outs: Dict[int, int]
    tally: MemoryTally
    flops: Any
    collectives: CollectiveCounter


def trace_call(fn, args, batch_arg: Optional[int] = None,
               batch_shards: int = 1) -> Trace:
    """Run ``fn(*args)`` once under a :class:`MemoryTally`, a
    ``FlopCounterMode`` and a :class:`CollectiveCounter`, inside the
    caller's ``FakeTensorMode`` and rules.  The arguments' storages are
    live from the start; ``args[batch_arg]``, a global batch that ``fn``
    shards, is counted at this rank's shard, ``1 / batch_shards`` of it."""
    from torch.utils.flop_counter import FlopCounterMode
    held = {}
    for i, a in enumerate(args):
        for key, n in _storages(a).items():
            held[key] = n // batch_shards if i == batch_arg else n
    tally = MemoryTally(held)
    flops = FlopCounterMode(display=False)
    coll = CollectiveCounter()
    with flops, coll, tally:
        out = fn(*args)
    return Trace(held, _storages(out), tally, flops, coll)


def capture(tr: Trace) -> Dict[str, Any]:
    """The reference's record of one trace.  ``memory``: the arguments
    (this rank's shards of state and batch), the outputs, the outputs that
    are arguments updated in place (``alias``: the donation), the
    temporaries (the peak beyond the arguments and the outputs that are
    not arguments, XLA's meaning, so that ``live_bytes`` by the reference's
    formula is the peak; for a train step, whose outputs beyond the state
    are a few scalars, the peak minus the arguments), no generated code;
    ``cost``: FLOPs and bytes accessed; ``collectives``; ``n_ops`` (the
    dispatched ops) in place of the HLO's length."""
    args = sum(tr.args.values())
    out = sum(tr.outs.values())
    alias = sum(n for k, n in tr.outs.items() if k in tr.args)
    mem = {"argument_size_in_bytes": args, "output_size_in_bytes": out,
           "temp_size_in_bytes": max(0, tr.tally.peak - args - (out - alias)),
           "alias_size_in_bytes": alias, "generated_code_size_in_bytes": 0}
    mem["live_bytes"] = (mem["argument_size_in_bytes"]
                         + mem["temp_size_in_bytes"]
                         + max(0, mem["output_size_in_bytes"]
                               - mem["alias_size_in_bytes"]))
    cost = {"flops": float(tr.flops.get_total_flops()),
            "bytes_accessed": float(tr.tally.bytes_accessed)}
    return {"memory": mem, "cost": cost,
            "collectives": tr.collectives.record(), "n_ops": tr.tally.n_ops}


def trace_cell(arch: str, shape: str, mesh, **kw):
    """:func:`build_cell` and one traced call of its ``fn`` under a fresh
    ``FakeTensorMode`` and the cell's rules; returns (the :class:`Trace`,
    ``{"trace_s", "microbatches", "repeated_blocks"}``, the last the calls
    of each kind of block that repeated its compute on every model rank,
    ``Rules.repeats``).  The twin of the reference's ``compile_cell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode():
        fn, args, _, _, rules, mb = build_cell(arch, shape, mesh, **kw)
        batch_arg = 2 if registry.SHAPES[shape].mode == "decode" else 1
        with partition.use_rules(rules):
            tr = trace_call(fn, args, batch_arg, rules.size("batch"))
    return tr, dict(trace_s=round(time.time() - t0, 2), microbatches=mb,
                    repeated_blocks=dict(rules.repeats))


def hbm_napkin(cfg, spec, mesh, mb: int) -> Dict[str, float]:
    """Analytic per-chip HBM budget (bytes), the reference's arithmetic: a
    float32 master copy, AdamW's moments and the gradients fully sharded
    over every chip, the remat stash and a layer's transient for training,
    the cache sharded on the model axis for serving."""
    sizes = mesh_sizes(mesh)
    chips = math.prod(sizes.values())
    dp = dp_size(mesh)
    params = cfg.param_count()
    p_bytes = params * 4 / chips              # f32 master, fully sharded
    opt_bytes = 2 * p_bytes                   # adam m, v
    grad_bytes = params * 4 / chips
    out = {"params": p_bytes, "opt": opt_bytes}
    if spec.mode == "train":
        rows = max(1, (spec.global_batch // mb) // dp)
        d_eff = _d_eff(cfg)
        stash = cfg.n_layers * rows * spec.seq_len * cfg.d_model * 2
        out.update(grads=grad_bytes, remat_stash=stash,
                   layer_transient=rows * spec.seq_len * d_eff * 2 * 8)
    elif spec.mode == "decode":
        rows = max(1, spec.global_batch // dp)
        model_shards = sizes.get("model", 1)
        ssm_state = rows * (
            cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            + (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
        if cfg.family == "ssm":
            cache = cfg.n_layers * ssm_state
        else:
            w = min(spec.seq_len, cfg.sliding_window or spec.seq_len)
            cache = ((cfg.n_layers - _n_mamba(cfg)) * rows
                     * (w / model_shards) * cfg.n_kv_heads * cfg.head_dim_
                     * 2 * 2)
            if _n_mamba(cfg):
                cache += _n_mamba(cfg) * ssm_state
        out["kv_cache"] = cache
    else:  # prefill
        rows = max(1, spec.global_batch // dp)
        out["activations"] = rows * spec.seq_len * cfg.d_model * 2 * 8
        model_shards = sizes.get("model", 1)
        out["kv_cache_out"] = ((cfg.n_layers - _n_mamba(cfg)) * rows
                               * (spec.seq_len / model_shards)
                               * cfg.n_kv_heads * cfg.head_dim_ * 2 * 2)
    out["total"] = float(sum(out.values()))
    return out


def run_cell(arch: str, shape: str, mesh_kind: str, *, probes=True,
             out_dir: Optional[str] = None, microbatches=None,
             rules_kind="fsdp", tag="baseline", extra_rules=None,
             remat=True) -> Dict[str, Any]:
    """One cell on the fake production mesh ``mesh_kind``: the full trace,
    the napkin, and (with ``probes``) the one- and two-unit probes at one
    microbatch and the corrected totals; written to ``out_dir`` as
    ``{arch}__{shape}__{mesh}__{tag}.json``.  A failure is recorded, not
    raised."""
    spec = registry.SHAPES[shape]
    cfg = registry.get_config(arch)
    rec: Dict[str, Any] = dict(arch=arch, shape=shape, mesh=mesh_kind,
                               mode=spec.mode, tag=tag, ok=False,
                               device=trace_device(), hbm_bytes=HBM_BYTES,
                               init_bytes=4 * cfg.param_count())
    kw = dict(rules_kind=rules_kind, extra_rules=extra_rules, remat=remat)
    try:
        with fake_mesh(*PRODUCTION[mesh_kind]) as mesh:
            tr, meta = trace_cell(arch, shape, mesh, microbatches=microbatches,
                                  **kw)
            rec.update(meta)
            rec["full"] = capture(tr)
            del tr
            rec["hbm_napkin"] = hbm_napkin(cfg, spec, mesh,
                                           rec["microbatches"])
            rec["ok"] = True
            if probes:
                rows = spec.global_batch // rec["microbatches"]
                rec["probes"] = {
                    f"u{units}": capture(trace_cell(
                        arch, shape, mesh, cfg=_probe_cfg(cfg, units),
                        microbatches=1, batch_rows=rows, **kw)[0])
                    for units in (1, 2)}
                rec["corrected"] = correct(rec, cfg)
    except Exception as e:  # noqa: BLE001 - record the failure verbatim
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def correct(rec: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Per-unit totals: M * (F + L_units * B) per metric, from the probes'
    B = cost(2u) - cost(u) and F = cost(u) - B."""
    u1, u2 = rec["probes"]["u1"], rec["probes"]["u2"]
    L = n_units(cfg)
    M = rec.get("microbatches", 1)
    out = {}
    for key, get in (
            ("flops", lambda c: c["cost"]["flops"]),
            ("bytes_accessed", lambda c: c["cost"]["bytes_accessed"]),
            ("collective_operand_bytes",
             lambda c: c["collectives"]["operand_bytes"]),
            ("collective_wire_bytes",
             lambda c: c["collectives"]["ring_wire_bytes"])):
        b = get(u2) - get(u1)
        f = get(u1) - b
        out[key] = M * (f + L * b)
        out[key + "_per_unit"] = b
        out[key + "_fixed"] = f
    return out


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--rules", default="fsdp")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", default="on", choices=["on", "off"])
    args = ap.parse_args(argv)

    if args.list:
        for a, s in registry.list_cells():
            print(f"{a:24s} {s}")
        return

    cells = registry.list_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch, shape in cells:
        reason = registry.cell_skip_reason(arch, shape)
        if reason:
            print(f"SKIP {arch}/{shape}: {reason}")
            continue
        for mk in meshes:
            t0 = time.time()
            rec = run_cell(arch, shape, mk, probes=not args.no_probes,
                           out_dir=args.out, microbatches=args.microbatches,
                           rules_kind=args.rules, tag=args.tag,
                           remat=(args.remat == "on"))
            status = "OK " if rec["ok"] else "FAIL"
            dt = time.time() - t0
            if rec["ok"]:
                mem = rec["full"]["memory"]
                per_dev = mem["live_bytes"] / 2**30
                print(f"{status} {arch}/{shape}/{mk} mb={rec['microbatches']} "
                      f"mem/dev={per_dev:.2f}GiB "
                      f"flops={rec['full']['cost']['flops']:.3g} "
                      f"coll={rec['full']['collectives']['n_collectives']} "
                      f"repeated={rec['repeated_blocks']} "
                      f"({dt:.0f}s)", flush=True)
            else:
                print(f"{status} {arch}/{shape}/{mk}: {rec['error']} "
                      f"({dt:.0f}s)", flush=True)


if __name__ == "__main__":
    main()

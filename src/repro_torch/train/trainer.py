"""Train and eval steps: gradient accumulation over strided microbatches,
float32 gradient sums, optional int8-compressed gradients.

Port of the JAX package's ``train/trainer.py``.  A step is a Python
function of the state and a batch of tensors on the model's device:
autograd takes the gradient of ``Model.loss_fn`` (per-layer remat inside
the model bounds the live activations to one microbatch and one layer) and
:meth:`AdamW.update` applies it in place.

Under ``partition`` rules the state is ``DTensor``s with the placements of
:func:`make_state_axes`; each rank takes its shard of the global batch
(``partition.shard_batch``).  The model-axis ranks of a batch shard compute
one loss between them (each its share of the split blocks), so what a rank
differentiates is that loss divided by ``partition.grad_ranks()``, the
number of ranks whose gradients sum: every rank but the model axis's.  A
weight's gradient comes back as a partial sum over those ranks
(``partition.wcast`` / ``wshard``), reduce-scattered to its placement: a
model-axis shard's gradient is its own, a weight every model rank uses
whole has the same one on each.  The summed gradient is then the mean over
the batch shards: the whole batch's when every shard holds as many
unmasked labels (a moe model's balance terms are whole-batch means,
``partition.batch_mean``), and a (1, m) mesh gives one device's loss and
gradients.  The loss in the metrics is the mean over the batch shards.

Under a ``torch.profiler`` a step records its spans (``repro_torch.spans``):
``train.step`` {``step``: the step function's call number, ``tokens``}
around ``train.batch`` (the batch onto the device and this rank's shard),
``train.forward`` (``Model.loss_fn``), ``train.backward``
(``torch.autograd.grad``, the remat recompute included) and
``train.optimizer`` {``leaves``, ``elements``, ``launches``: the AdamW
kernel's launches, 3 on the card, 0 on the CPU} (``AdamW.update``); with
microbatches, forward and backward under ``train.microbatch`` {``mb``}.
``train.backward`` and ``train.optimizer`` also time themselves on the card
(``timed``).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch import partition, spans
from repro_torch.kernels import adamw as adamw_kernel
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.compression import compress_int8, decompress_int8


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor   # int32 scalar


def init_state(model: Model, optimizer: AdamW, seed: int = 0) -> TrainState:
    """Parameters from ``seed`` on the model's device, zero moments.  Under
    rules the whole parameters are built from the seed as without them,
    then distributed, so every value is the unsharded init's."""
    params = model.init(seed)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    rules = partition.current_rules()
    if rules is not None:
        axes = make_state_axes(model.param_axes())
        params = partition.place(params,
                                 partition.param_shardings(rules, axes.params))
        step = partition.place(step, rules.sharding(axes.step))
    return TrainState(params=params, opt=optimizer.init(params), step=step)


def init_state_shapes(model: Model, optimizer: AdamW) -> TrainState:
    """:func:`init_state`'s state without values, for a trace: the
    parameters of ``Model.param_shapes`` and the moments as
    ``zeros_like`` (fake under a ``FakeTensorMode``).  Under rules each
    leaf is this rank's shard as a ``DTensor``, cut locally with no
    collective."""
    params = model.param_shapes()
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    rules = partition.current_rules()
    if rules is not None:
        axes = make_state_axes(model.param_axes())
        params = partition.place(
            params, partition.param_shardings(rules, axes.params), local=True)
        step = partition.place(step, rules.sharding(axes.step), local=True)
    return TrainState(params=params, opt=optimizer.init(params), step=step)


def make_state_axes(param_axes):
    """Logical-axes tree matching :func:`init_state`'s output: optimizer
    moments inherit the parameter shardings, scalars are replicated."""
    return TrainState(params=param_axes,
                      opt=OptState(m=param_axes, v=param_axes, count=()),
                      step=())


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """Split a global batch into ``n`` strided microbatches: microbatch m
    takes rows {i * n + m}, as the reference's does."""

    def split(x, m):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split into {n} "
                             "microbatches")
        return x.reshape(b // n, n, *x.shape[1:])[:, m]

    return [{k: split(v, m) for k, v in batch.items()} for m in range(n)]


def make_train_step(model: Model, optimizer: AdamW, *,
                    microbatches: int = 1, remat: bool = True,
                    compress_grads: bool = False, param_axes=None):
    """The train step ``step(state, batch) -> (state, metrics)``.

    ``batch``: tensors (or arrays) of the data pipeline's keys.  With
    ``microbatches`` > 1 the gradients of the strided microbatches are
    summed in float32 and divided by their count, as is the loss.
    ``compress_grads``: int8-quantize the gradients and dequantize them
    before the optimizer, carrying the squared quantization error in the
    metrics as ``quant_err``.  ``param_axes``: the parameters' logical-axes
    tree (``model.param_axes()``); under rules the gradient tree is
    constrained to it, as the reference constrains its gradient sums.  The
    returned state holds the argument's tensors, updated in place."""

    def constrain_grads(g):
        if param_axes is None:
            return g
        return pytree.tree_map(partition.constrain, g, param_axes)

    def grad_of(params, mb, ranks):
        leaves, spec = pytree.tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        with spans.span("train.forward"):
            loss, metrics = model.loss_fn(pytree.tree_unflatten(live, spec),
                                          mb, remat=remat)
        with spans.span("train.backward", timed=True):
            grads = torch.autograd.grad(loss / ranks if ranks > 1 else loss,
                                        live)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            pytree.tree_unflatten(list(grads), spec)

    calls = itertools.count()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with spans.span("train.step", step=next(calls)) as traced:
            return step_body(state, batch, traced)

    def step_body(state, batch, traced):
        params = state.params
        with spans.span("train.batch"):
            batch = {k: partition.shard_batch(
                torch.as_tensor(v, device=model.device))
                for k, v in batch.items()}
        if traced is not None:
            traced.attrs["tokens"] = batch["tokens"].numel()
        ranks = partition.grad_ranks()
        if microbatches == 1:
            loss, metrics, grads = grad_of(params, batch, ranks)
            grads = constrain_grads(grads)
        else:
            grads, lsum = None, 0.0
            for i, mb in enumerate(_microbatches(batch, microbatches)):
                with spans.span("train.microbatch", mb=i):
                    l, _, g = grad_of(params, mb, ranks)
                    g = pytree.tree_map(lambda t: t.float(), g)
                    if grads is not None:
                        g = pytree.tree_map(torch.add, grads, g)
                    grads = constrain_grads(g)
                    lsum = lsum + l
                    del g
            grads = pytree.tree_map(lambda g: g / microbatches, grads)
            loss = lsum / microbatches
            metrics = {}

        if compress_grads:
            with torch.no_grad():
                deq = pytree.tree_map(
                    lambda g: decompress_int8(*compress_int8(g.float())),
                    grads)
                qerr = sum(torch.sum(torch.square(a.float() - b))
                           for a, b in zip(pytree.tree_leaves(grads),
                                           pytree.tree_leaves(deq)))
            grads = deq
            metrics = dict(metrics, quant_err=qerr)

        with spans.span("train.optimizer", timed=True) as s:
            if s is not None:
                leaves = pytree.tree_leaves(grads)
                s.attrs.update(leaves=len(leaves),
                               elements=sum(g.numel() for g in leaves))
                launched = adamw_kernel.launches()
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state.opt, params)
            if s is not None:
                s.attrs["launches"] = adamw_kernel.launches() - launched
        if ranks > 1:
            loss = partition.mesh_sum(loss.clone(),
                                      partition.grad_dims()) / ranks
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


def make_eval_step(model: Model, *, remat: bool = False):
    """``step(params, batch) -> metrics`` (the loss and its parts), without
    gradients."""

    @torch.no_grad()
    def step(params, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, metrics = model.loss_fn(params, batch, remat=remat)
        return dict(metrics, loss=loss)

    return step

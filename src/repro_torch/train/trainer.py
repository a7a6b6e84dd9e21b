"""Train and eval steps: gradient accumulation over strided microbatches,
float32 gradient sums, optional int8-compressed gradients.

Port of the JAX package's ``train/trainer.py`` on one card.  A step is a
Python function of the state and a batch of tensors on the model's device:
autograd takes the gradient of ``Model.loss_fn`` (per-layer remat inside
the model bounds the live activations to one microbatch and one layer) and
:meth:`AdamW.update` applies it in place.  The reference's ``param_axes``
(the logical axes that shard the gradient sums) has no twin until
``partition.py`` is ported (ROADMAP.md Queue 1), nor has
``make_state_axes``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.compression import compress_int8, decompress_int8


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor   # int32 scalar


def init_state(model: Model, optimizer: AdamW, seed: int = 0) -> TrainState:
    """Parameters from ``seed`` on the model's device, zero moments."""
    params = model.init(seed)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


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
                    compress_grads: bool = False):
    """The train step ``step(state, batch) -> (state, metrics)``.

    ``batch``: tensors (or arrays) of the data pipeline's keys.  With
    ``microbatches`` > 1 the gradients of the strided microbatches are
    summed in float32 and divided by their count, as is the loss.
    ``compress_grads``: int8-quantize the gradients and dequantize them
    before the optimizer, carrying the squared quantization error in the
    metrics as ``quant_err``.  The returned state holds the argument's
    tensors, updated in place."""

    def grad_of(params, mb):
        leaves, spec = pytree.tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        loss, metrics = model.loss_fn(pytree.tree_unflatten(live, spec), mb,
                                      remat=remat)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            pytree.tree_unflatten(list(grads), spec)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if microbatches == 1:
            loss, metrics, grads = grad_of(params, batch)
        else:
            grads, lsum = None, 0.0
            for mb in _microbatches(batch, microbatches):
                l, _, g = grad_of(params, mb)
                g = pytree.tree_map(lambda t: t.float(), g)
                grads = g if grads is None else pytree.tree_map(
                    torch.add, grads, g)
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

        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, params)
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

"""Int8 gradient compression with error feedback.

Port of the JAX package's ``optim/compression.py``: per-tensor symmetric
int8 quantization; the quantization residual is kept in an error-feedback
accumulator and added back before the next step's quantization.  The
trainer's ``compress_grads`` path quantizes and dequantizes the
accumulated gradients in one step (the model of a compressed data-parallel
reduction on one card).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class CompressionState(NamedTuple):
    error: Any  # error-feedback accumulator, same tree as grads (f32)


def init_compression(grads_like) -> CompressionState:
    return CompressionState(error=pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale f32 scalar)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, state: CompressionState):
    """Quantize a gradient tree with error feedback.  Returns (the tree of
    (q, scale) pairs, the dequantized tree, the new state)."""
    flat, spec = pytree.tree_flatten(grads)
    errors = pytree.tree_leaves(state.error)
    compensated = [g.float() + e for g, e in zip(flat, errors)]
    qs = [compress_int8(c) for c in compensated]
    deq = [decompress_int8(q, s) for q, s in qs]
    new_err = [c - d for c, d in zip(compensated, deq)]
    return (pytree.tree_unflatten(qs, spec), pytree.tree_unflatten(deq, spec),
            CompressionState(error=pytree.tree_unflatten(new_err, spec)))

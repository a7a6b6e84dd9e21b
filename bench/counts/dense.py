"""Operations and bytes of a dense decoder (``bench/reference/dense.py``'s
model), counted from its shapes.

Model FLOPs count what the model needs once, not what an implementation
recomputes: 2 a multiply-add of every matrix parameter a token touches
(the projections, the MLP and the output head over the real vocabulary),
times 3 for a training step (forward, and the backward's two products a
weight), plus attention: 2 products of 2 dh a live (query, key) pair a
head in the forward (Q K^T, P V), twice that in the backward.
"""

from __future__ import annotations

from typing import Iterable

from bench.counts.common import least_s, live_pairs


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def matmul_params(m: dict) -> int:
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    q, kv = m["n_heads"] * head_dim(m), m["n_kv_heads"] * head_dim(m)
    layer = d * q + 2 * d * kv + q * d + 3 * d * ff
    return m["n_layers"] * layer + d * V


def attention_fwd_ops(m: dict, B: int, S: int) -> int:
    """Q K^T and P V over the live pairs of every head, every layer's share
    being one call: the operations of one call (one layer)."""
    return 4 * head_dim(m) * m["n_heads"] * B * live_pairs(
        S, m.get("sliding_window"))


def train_step_flops(m: dict, B: int, S: int) -> int:
    return (6 * matmul_params(m) * B * S
            + 3 * m["n_layers"] * attention_fwd_ops(m, B, S))


def prefill_flops(m: dict, lengths: Iterable[int]) -> int:
    """A prefill's model FLOPs over the prompts' own tokens (no pads)."""
    return sum(2 * matmul_params(m) * n
               + m["n_layers"] * attention_fwd_ops(m, 1, n) for n in lengths)


def attention_fwd_bound_s(m: dict, B: int, S: int, lse: bool) -> float:
    """Least time of one forward attention call: 2 products a live pair,
    q, k, v read and o written once in bf16 (and the float32 row
    log-sum-exp where the call writes it for a backward)."""
    H, KV, dh = m["n_heads"], m["n_kv_heads"], head_dim(m)
    nbytes = 2 * B * S * dh * (2 * H + 2 * KV) + (4 * B * H * S if lse else 0)
    return least_s(attention_fwd_ops(m, B, S), nbytes)


def attention_bwd_bound_s(m: dict, B: int, S: int) -> float:
    """Least time of one backward attention call: 5 products a live pair
    (S and dP recomputed, dV, dK, dQ: FlashAttention-2's count); q, k, v,
    o, dO and the float32 log-sum-exp read and dq, dk, dv written once."""
    H, KV, dh = m["n_heads"], m["n_kv_heads"], head_dim(m)
    ops = attention_fwd_ops(m, B, S) * 5 // 2
    nbytes = 2 * B * S * dh * (4 * H + 4 * KV) + 4 * B * H * S
    return least_s(ops, nbytes)

"""Operations and bytes of a Mamba-2 + attention hybrid
(``bench/reference/ssm_hybrid.py``'s model), counted from its shapes.

Model FLOPs, as the dense and SSM counts take them: 2 a multiply-add of
every matrix parameter a token touches (each layer's mixer, the Mamba-2
layers' input and output projections and depthwise convolution or the
attention layers' four projections, each layer's MLP, and the tied head
over the real vocabulary), times 3 for a training step; plus, times 3, the
attention layers' scores over their live (query, key) pairs (full causal:
no window) and the Mamba-2 layers' SSD scan in its chunked form.  Each
kernel's least time is one call's, one layer's, from the dense and SSM
counts at this model's widths.
"""

from __future__ import annotations

from bench.counts import dense, ssm
from bench.counts.dense import attention_bwd_bound_s, attention_fwd_bound_s
from bench.counts.ssm import ssd_bwd_bound_s, ssd_fwd_bound_s

__all__ = ["matmul_params", "layer_counts", "train_step_flops",
           "attention_fwd_bound_s", "attention_bwd_bound_s",
           "ssd_fwd_bound_s", "ssd_bwd_bound_s"]


def layer_counts(m: dict) -> dict:
    """How many layers of each kind the model has."""
    kinds = list(m["block_pattern"]) * (m["n_layers"]
                                        // len(m["block_pattern"]))
    return {k: kinds.count(k) for k in ("mamba", "attn")}


def matmul_params(m: dict) -> int:
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    hd = dense.head_dim(m)
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    di, n, _, h = ssm.sizes(m)
    mamba = d * (2 * di + 2 * n + h) + m["conv_width"] * (di + 2 * n) + di * d
    attn = d * q + 2 * d * kv + q * d
    n_kind = layer_counts(m)
    return (n_kind["mamba"] * mamba + n_kind["attn"] * attn
            + m["n_layers"] * 3 * d * ff + d * V)


def train_step_flops(m: dict, B: int, S: int) -> int:
    n_kind = layer_counts(m)
    return (6 * matmul_params(m) * B * S
            + 3 * n_kind["attn"] * dense.attention_fwd_ops(m, B, S)
            + 3 * n_kind["mamba"] * ssm.ssd_fwd_ops(m, B, S))

"""Operations and bytes of Mamba-2 (``bench/reference/ssm.py``'s model),
counted from its shapes.

Model FLOPs: 2 a multiply-add of every matrix parameter a token touches
(the input and output projections, the depthwise convolution, the tied
head over the real vocabulary), times 3 for a training step, plus the SSD
scan in its chunked form at ``CHUNK`` tokens, times 3 for a training step.
"""

from __future__ import annotations

from bench.counts.common import least_s

#: The chunk the scan's operations are counted at.
CHUNK = 64


def sizes(m: dict):
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_state"], m["ssm_head_dim"], di // m["ssm_head_dim"]


def matmul_params(m: dict) -> int:
    d, V = m["d_model"], m["vocab_size"]
    di, n, _, h = sizes(m)
    layer = d * (2 * di + 2 * n + h) + m["conv_width"] * (di + 2 * n) + di * d
    return m["n_layers"] * layer + d * V


def ssd_fwd_ops(m: dict, B: int, S: int) -> int:
    """One scan call: C B^T on and below each chunk's diagonal (shared by
    the heads), then a head's masked product with x, its chunk state B^T x
    and the state's share of the output C s."""
    _, n, p, h = sizes(m)
    nc, tri = -(-S // CHUNK), CHUNK * (CHUNK + 1) // 2
    return B * nc * (2 * tri * n + h * (2 * tri * p + 4 * CHUNK * n * p))


def ssd_bwd_ops(m: dict, B: int, S: int) -> int:
    """One backward call: C B^T recomputed, and two products for each of
    the forward's (the cotangents of both operands)."""
    _, n, _, _ = sizes(m)
    nc, tri = -(-S // CHUNK), CHUNK * (CHUNK + 1) // 2
    return 2 * ssd_fwd_ops(m, B, S) + B * nc * 2 * tri * n


def train_step_flops(m: dict, B: int, S: int) -> int:
    return (6 * matmul_params(m) * B * S
            + 3 * m["n_layers"] * ssd_fwd_ops(m, B, S))


def ssd_fwd_bound_s(m: dict, B: int, S: int) -> float:
    """Least time of one scan call over its operands: x, dt, a, b, c read,
    y and the float32 final state written, once each."""
    _, n, p, h = sizes(m)
    nbytes = (2 * B * S * h * p * 2 + B * S * h * 4 + h * 4 + 2 * B * S * n * 2
              + B * h * p * n * 4)
    return least_s(ssd_fwd_ops(m, B, S), nbytes)


def ssd_bwd_bound_s(m: dict, B: int, S: int) -> float:
    """Least time of one backward call over its operands: x, dy, dt, a, b, c
    read and dx, ddt, da, db, dc written, once each (no initial state and
    no cotangent of the final one in training)."""
    _, n, p, h = sizes(m)
    nbytes = (3 * B * S * h * p * 2 + 2 * B * S * h * 4 + 2 * h * 4
              + 4 * B * S * n * 2)
    return least_s(ssd_bwd_ops(m, B, S), nbytes)

"""The benchmark's operation and byte counts against counts made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from bench.counts import common, dense, ssm
from bench.tests.bench_helpers import TINY_MODELS

DANUBE = {"n_layers": 24, "d_model": 2560, "n_heads": 32, "n_kv_heads": 8,
          "d_ff": 6912, "vocab_size": 32000, "sliding_window": 4096}


def _pairs_by_hand(S, W):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    ok = k <= q
    if W:
        ok &= k > q - W
    return int(ok.sum())


@pytest.mark.parametrize("S,W", [(64, None), (64, 16), (100, 100), (300, 64),
                                 (1000, 100)])
def test_live_pairs(S, W):
    assert common.live_pairs(S, W) == _pairs_by_hand(S, W)


def test_danube_counts_at_its_three_shapes():
    d, ff, q, kv, V = 2560, 6912, 2560, 640, 32000
    n = 24 * (d * q + 2 * d * kv + q * d + 3 * d * ff) + d * V
    assert dense.matmul_params(DANUBE) == n == 1_749_155_840
    for B, S, pairs in ((8, 2048, 2048 * 2049 // 2),
                        (1, 16384, 4096 * 4097 // 2 + (16384 - 4096) * 4096),
                        (16, 8192, 4096 * 4097 // 2 + 4096 * 4096)):
        attn = 4 * 80 * 32 * B * pairs
        assert dense.attention_fwd_ops(DANUBE, B, S) == attn
        assert dense.train_step_flops(DANUBE, B, S) == (
            6 * n * B * S + 3 * 24 * attn)
        fwd_bytes = 2 * B * S * 80 * (2 * 32 + 2 * 8)
        assert dense.attention_fwd_bound_s(DANUBE, B, S, False) == max(
            attn / 989e12, fwd_bytes / 3.35e12)
        bwd_bytes = 2 * B * S * 80 * (4 * 32 + 4 * 8) + 4 * B * 32 * S
        assert dense.attention_bwd_bound_s(DANUBE, B, S) == max(
            attn * 2.5 / 989e12, bwd_bytes / 3.35e12)


def test_prefill_counts_each_prompt_alone():
    m = TINY_MODELS["tiny-dense"]["model"]
    lengths = [5, 30, 17]
    want = sum(2 * dense.matmul_params(m) * n
               + m["n_layers"] * 4 * m["head_dim"] * m["n_heads"]
               * _pairs_by_hand(n, m["sliding_window"]) for n in lengths)
    assert dense.prefill_flops(m, lengths) == want


def test_ssd_counts_by_chunk():
    m = {"n_layers": 48, "d_model": 1024, "vocab_size": 50280, "ssm_state": 128,
         "ssm_expand": 2, "ssm_head_dim": 64, "conv_width": 4}
    B, S, H, P, N, Q = 8, 2048, 32, 64, 128, 64
    per_chunk = 0
    for i in range(Q):              # row i of a chunk sees i + 1 positions
        per_chunk += 2 * (i + 1) * N + H * 2 * (i + 1) * P
    per_chunk += H * 4 * Q * N * P
    assert ssm.ssd_fwd_ops(m, B, S) == B * (S // Q) * per_chunk
    layer = 1024 * (2 * 2048 + 2 * 128 + 32) + 4 * (2048 + 256) + 2048 * 1024
    assert ssm.matmul_params(m) == 48 * layer + 1024 * 50280
    fwd_bytes = (2 * B * S * H * P * 2 + B * S * H * 4 + H * 4
                 + 2 * B * S * N * 2 + B * H * P * N * 4)
    assert ssm.ssd_fwd_bound_s(m, B, S) == max(
        ssm.ssd_fwd_ops(m, B, S) / 989e12, fwd_bytes / 3.35e12)

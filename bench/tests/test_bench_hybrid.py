"""The hybrid's pieces of the benchmark: its counts against a hand count, its
configuration's file, and a whole tiny hybrid cell on the CPU, the program
within the tiny training limits and the float8 control outside them."""

from __future__ import annotations

import json

import pytest
import torch

from bench import run as bench_run
from bench.calibrate import calibrate
from bench.common import compare
from bench.counts import ssm_hybrid as counts
from bench.tests.bench_helpers import ROOT, TINY_LIMITS, make_root

GRANITE = json.loads((ROOT / "bench/configs/granite-4.0-h-micro.json")
                     .read_text())
CELL = "granite-h-micro-train-16k"
#: A reduced hybrid (a Mamba-2 layer, then a full NoPE attention layer,
#: twice) with granite-4.0-h's multipliers.
TINY_HYBRID = {"reference": "ssm_hybrid", "model": {
    "name": "tiny-hybrid", "family": "hybrid", "n_layers": 4, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
    "vocab_size": 512, "mlp_type": "swiglu", "ssm_state": 16,
    "ssm_expand": 2, "ssm_head_dim": 16, "ssm_chunk": 16, "conv_width": 4,
    "block_pattern": ["mamba", "attn"], "local_window": None,
    "tie_embeddings": True, "norm_eps": 1e-05, "embedding_multiplier": 12.0,
    "residual_multiplier": 0.22, "attention_multiplier": 0.03125,
    "logits_scaling": 8.0, "position_embedding": "nope"}}
SEEDS = [2**31 + 101, 2**31 + 202]


def test_counts_by_hand():
    """granite-4.0-h-micro at B 1 x S 16,384, from its widths."""
    m = GRANITE["model"]
    mamba = 2048 * (2 * 4096 + 2 * 128 + 64) + 4 * (4096 + 256) + 4096 * 2048
    attn = 2048 * 2048 * 2 + 2 * 2048 * 512
    mlp = 3 * 2048 * 8192
    params = 36 * mamba + 4 * attn + 40 * mlp + 2048 * 100_352
    assert counts.matmul_params(m) == params == 3_190_919_168
    assert counts.layer_counts(m) == {"mamba": 36, "attn": 4}
    S = 16_384
    attn_ops = 4 * 64 * 32 * (S * (S + 1) // 2)       # Q K^T, P V
    tri = 64 * 65 // 2                                # a 64-token chunk
    ssd_ops = (S // 64) * (2 * tri * 128
                           + 64 * (2 * tri * 64 + 4 * 64 * 128 * 64))
    assert counts.train_step_flops(m, 1, S) == (
        6 * params * S + 3 * 4 * attn_ops + 3 * 36 * ssd_ops)
    # About 3.3e14 a step: 6 x 3.19e9 x 16,384 and the two scans.
    assert 3.2e14 < counts.train_step_flops(m, 1, S) < 3.4e14
    # The kernels' least times: attention by its operations at 989e12,
    # the SSD scans by their bytes at 3.35e12.
    assert counts.attention_fwd_bound_s(m, 1, S, True) == pytest.approx(
        attn_ops / 989e12)
    assert counts.attention_bwd_bound_s(m, 1, S) == pytest.approx(
        attn_ops * 5 / 2 / 989e12)
    fwd_bytes = (2 * S * 4096 * 2 + S * 64 * 4 + 64 * 4 + 2 * S * 128 * 2
                 + 64 * 64 * 128 * 4)
    bwd_bytes = (3 * S * 4096 * 2 + 2 * S * 64 * 4 + 2 * 64 * 4
                 + 4 * S * 128 * 2)
    assert counts.ssd_fwd_bound_s(m, 1, S) == pytest.approx(fwd_bytes / 3.35e12)
    assert counts.ssd_bwd_bound_s(m, 1, S) == pytest.approx(bwd_bytes / 3.35e12)


def test_the_configuration_file():
    """The catalog's published config whole, at the top level and under
    ``published``, the exact parameter count, no cut."""
    from bench.reference import ssm_hybrid
    pub = GRANITE["published"]
    assert all(GRANITE[k] == v for k, v in pub.items())
    assert GRANITE["reduced"] == GRANITE["assumed"] == []
    n = sum(torch.Size(s).numel()
            for _, s, _ in ssm_hybrid.param_specs(GRANITE["model"]))
    assert n == GRANITE["parameters"] == 3_191_396_096
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "granite-4.0-h-micro", "train-16k", 1)
    limits = json.loads((ROOT / "bench/limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"loss1_rel", "grad_gap", "change_gap"}


def _hybrid_root(tmp_path):
    root = make_root(tmp_path)
    (root / "bench/configs/tiny-hybrid.json").write_text(
        json.dumps({"name": "tiny-hybrid", **TINY_HYBRID}))
    (root / "bench/limits/hybrid-train.json").write_text(
        json.dumps(TINY_LIMITS["train"]))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-hybrid", "source": "test",
                             "file": "bench/configs/tiny-hybrid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "hybrid-train", "config": "tiny-hybrid",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def test_a_tiny_hybrid_cell_runs_whole(tmp_path):
    root, bench = _hybrid_root(tmp_path)
    line = bench_run.run_cell(root, bench, "hybrid-train", 2**31 + 11, 0.3,
                              False, torch.device("cpu"))
    assert line["correct"] is True and line["attempted"] > 0
    assert {"train_tokens_per_s", "setup_s"} <= set(line["metrics"])


def test_program_within_and_control_outside_the_limits(tmp_path):
    """At the tiny size the program reads loss_rel <= 2.9e-6, grad_gap <=
    3.3e-3, change_gap <= 1.4e-3 (three seeds on the CPU); the float8
    control grad_gap >= 1.7e-2, outside the tiny cells' 8e-3."""
    root, bench = _hybrid_root(tmp_path)
    limits = TINY_LIMITS["train"]
    lines = calibrate(root, bench, "hybrid-train", SEEDS, set(SEEDS), set(),
                      torch.device("cpu"), emit=lambda s: None)
    assert {line["side"] for line in lines} == {"program", "control"}
    for line in lines:
        values = {k: line[k] for k in limits}
        ok = compare.passed(compare.judge(values, limits))
        assert ok == (line["side"] == "program"), line

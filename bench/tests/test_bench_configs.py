"""The configurations' files against their published configs and the port's
presets, and the benchmark's parameter layout against the port's own."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils import _pytree as pytree

from bench.tests.bench_helpers import ROOT, TINY_MODELS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def published_rows(pub: dict) -> int:
    """The vocabulary rows the published model holds: its ``vocab_size``,
    padded to ``pad_vocab_size_multiple`` where the config gives one."""
    pad = pub.get("pad_vocab_size_multiple", 1)
    return -(-pub["vocab_size"] // pad) * pad


def _shapes(tree):
    leaves, spec = pytree.tree_flatten(tree)
    return spec, [tuple(t.shape) for t in leaves]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_is_the_ports_preset(entry):
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["name"] == entry["name"] and body["chips"] == 1
    # The preset in every key but the vocabulary, which holds the published
    # model's rows (mamba2-370m's preset pads its 50,277 ids to 50,280).
    preset = registry.get_config(entry["name"])
    assert ModelConfig(**body["model"]) == dataclasses.replace(
        preset, vocab_size=published_rows(body["published"]))
    assert entry["reduced"] == body["reduced"] == []


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-370m"])
def test_published_widths(name):
    body = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    m, pub = body["model"], body["published"]
    if body["reference"] == "dense":
        assert (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"],
                m["d_ff"], m["vocab_size"], m["sliding_window"]) == (
            pub["num_hidden_layers"], pub["hidden_size"],
            pub["num_attention_heads"], pub["num_key_value_heads"],
            pub["intermediate_size"], pub["vocab_size"], pub["sliding_window"])
    else:
        ssm = pub["ssm_cfg"]
        assert (m["n_layers"], m["d_model"], m["ssm_state"], m["ssm_expand"],
                m["ssm_head_dim"], m["conv_width"], m["ssm_chunk"],
                m["vocab_size"], m["tie_embeddings"]) == (
            pub["n_layer"], pub["d_model"], ssm["d_state"], ssm["expand"],
            ssm["headdim"], ssm["d_conv"], ssm["chunk_size"],
            published_rows(pub), pub["tie_embeddings"])


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-370m",
                                  *TINY_MODELS])
def test_benchmark_weights_have_the_ports_layout(name):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from bench.common import weights
    from bench.reference import follow
    body = (TINY_MODELS[name] if name in TINY_MODELS else json.loads(
        (ROOT / "bench" / "configs" / f"{name}.json").read_text()))
    specs = follow.family(body["reference"]).param_specs(body["model"])
    ours = weights.tree_of([p for p, _, _ in specs],
                           [torch.empty(s, device="meta") for _, s, _ in specs])
    port = Model(ModelConfig(**body["model"]), device="meta").param_shapes()
    assert _shapes(ours) == _shapes(port)


def test_danube_parameter_count():
    from bench.reference import dense
    body = json.loads((ROOT / "bench/configs/h2o-danube-1.8b.json").read_text())
    n = sum(torch.Size(s).numel() for _, s, _ in
            dense.param_specs(body["model"]))
    assert n == body["parameters"] == 1_831_201_280


def test_mamba2_parameter_count():
    from bench.reference import ssm
    body = json.loads((ROOT / "bench/configs/mamba2-370m.json").read_text())
    n = sum(torch.Size(s).numel() for _, s, _ in ssm.param_specs(body["model"]))
    assert n == body["parameters"] == 368_494_080

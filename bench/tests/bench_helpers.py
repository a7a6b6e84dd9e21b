"""Tiny cells for whole runs of the benchmark on the CPU: reduced
configurations of the two families, small mixes, and a checkout that holds
them as new files beside the benchmark's own drivers and metrics."""

from __future__ import annotations

import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Reduced configurations of the two families (the CPU runs the port's
#: plain versions of its kernels).
TINY_MODELS = {
    "tiny-dense": {"reference": "dense", "model": {
        "name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 128,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 192,
        "vocab_size": 4096, "mlp_type": "swiglu", "sliding_window": 24,
        "rope_theta": 10000.0, "norm_eps": 1e-05}},
    "tiny-ssm": {"reference": "ssm", "model": {
        "name": "tiny-ssm", "family": "ssm", "n_layers": 2, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "d_ff": 0, "vocab_size": 512,
        "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16,
        "ssm_chunk": 16, "conv_width": 4, "tie_embeddings": True,
        "norm_eps": 1e-05}},
}
OPTIMIZER = {"lr": 3e-4, "warmup": 20, "total": 10000, "b1": 0.9,
             "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
TINY_MIXES = {
    "tiny-train": {"kind": "train", "batch": 2, "seq": 48,
                   "zipf_exponent": 1.1, "optimizer": OPTIMIZER},
    "tiny-serve": {"kind": "serve", "batch": 4, "new_tokens": 8,
                   "median": 20, "sigma": 0.8, "min": 8, "max": 40,
                   "pool": 2, "zipf_exponent": 1.1, "check_requests": 8},
}
TINY_CELLS = {
    "dense-train": ("tiny-dense", "tiny-train"),
    "ssm-train": ("tiny-ssm", "tiny-train"),
    "dense-serve": ("tiny-dense", "tiny-serve"),
}
#: Limits of the tiny cells, set as the cells' own are: from the program's
#: readings and the float8 control's at this size (six seeds each, on the
#: CPU: program loss_rel <= 4.3e-5, grad_gap <= 3.9e-3, change_gap <=
#: 5.3e-3, logit_gap <= 3.6e-3; control loss_rel >= 1.2e-4, logit_gap >=
#: 2.1e-2, grad_gap >= 6.6e-3 dense, 2.4e-2 ssm).
TINY_LIMITS = {"train": {"loss_rel": 1e-4, "grad_gap": 8e-3,
                         "change_gap": 1e-2},
               "serve": {"logit_gap": 1.2e-2}}


def make_root(tmp: Path) -> Path:
    """A checkout holding the tiny cells: new files under ``bench/configs``,
    ``bench/traffic`` and ``bench/limits`` and entries in its
    ``BENCHMARK.json``; the drivers and metrics are the benchmark's own."""
    bench_dir = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench_dir / sub).mkdir(parents=True)
    for sub in ("drivers", "metrics"):
        os.symlink(ROOT / "bench" / sub, bench_dir / sub)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = []
    for name, body in TINY_MODELS.items():
        path = f"bench/configs/{name}.json"
        (tmp / path).write_text(json.dumps({"name": name, **body}))
        configs.append({"name": name, "source": "test", "file": path,
                        "reduced": [], "why": "test"})
    for name, mix in TINY_MIXES.items():
        (bench_dir / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    workloads = []
    for cell, (cfg, mix) in TINY_CELLS.items():
        kind = TINY_MIXES[mix]["kind"]
        (bench_dir / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS[kind]))
        workloads.append({"name": cell, "config": cfg, "traffic": mix,
                          "chips": 1, "why": "test"})
    bench = dict(real, configs=configs, workloads=workloads)
    for key in ("end_to_end", "per_layer"):
        bench[key] = [{k: v for k, v in e.items() if k != "workloads"}
                      for e in real[key]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp

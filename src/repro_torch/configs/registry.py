"""Architecture registry: the ten assigned configurations by name.

The config files beside this one are data, copied from the JAX package.
Its ``input_specs`` / ``input_logical_axes`` (shape stand-ins for the
dry-run) are not ported yet.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "mamba2-370m",
    "stablelm-12b",
    "h2o-danube-1.8b",
    "qwen2-72b",
    "nemotron-4-15b",
    "internvl2-2b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-30b-a3b",
    "whisper-base",
    "recurrentgemma-2b",
)

_MOD = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
        for a in ARCHS}
_CACHE: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CACHE:
        if arch not in _MOD:
            raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
        _CACHE[arch] = importlib.import_module(_MOD[arch]).CONFIG
    return _CACHE[arch]

"""Architecture registry, input shapes, and dry-run cell enumeration.

Port of the JAX package's ``configs/registry.py``; the config files beside
this one are data, copied from it, except those of
:data:`PORT_ONLY_ARCHS`.  torch has no ``ShapeDtypeStruct``:
:func:`input_specs` returns :class:`InputSpec` records (a shape and a
torch dtype), which the dry-run turns into fake tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, NamedTuple, Optional

import torch

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
#: Architectures of the port alone, with no twin in the JAX package (its
#: tests hold them to the benchmark's plain references instead).
PORT_ONLY_ARCHS = ("granite-4.0-h-micro",)
ALL_ARCHS = ARCHS + PORT_ONLY_ARCHS

_MOD = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
        for a in ALL_ARCHS}
_CACHE: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CACHE:
        if arch not in _MOD:
            raise KeyError(f"unknown arch {arch!r}; choose from {ALL_ARCHS}")
        _CACHE[arch] = importlib.import_module(_MOD[arch]).CONFIG
    return _CACHE[arch]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs whose attention is sub-quadratic / O(1)-state at decode; only these
# run the 524k-context cell (the assignment's prescribed skip for pure
# full-attention archs).
LONG_CONTEXT_OK = {"mamba2-370m", "recurrentgemma-2b", "h2o-danube-1.8b"}


def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the (arch x shape) cell runs; else the reason it is skipped."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("full quadratic attention at 524k tokens / batch 1: "
                "unshardable batch, quadratic score matrix (DESIGN.md skip)")
    return None


def list_cells(include_skipped: bool = False):
    out = []
    for a in ARCHS:
        for s in SHAPES:
            reason = cell_skip_reason(a, s)
            if reason is None or include_skipped:
                out.append((a, s))
    return out


CELLS = list_cells()


class InputSpec(NamedTuple):
    """A model input's shape and dtype, the twin of ``ShapeDtypeStruct``."""
    shape: tuple
    dtype: torch.dtype


def input_specs(arch: str, shape: str) -> Dict[str, InputSpec]:
    """Shape and dtype of every model input of one cell.

    * train:   {tokens, labels [B, S] int32} (+ modality extras)
    * prefill: {tokens [B, S] int32} (+ extras)
    * decode:  {token [B] int32} - the cache comes from ``Model.init_cache``
      in the dry-run.
    """
    cfg = get_config(arch)
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    out: Dict[str, InputSpec] = {}
    if spec.mode == "train":
        out["tokens"] = InputSpec((B, S), torch.int32)
        out["labels"] = InputSpec((B, S), torch.int32)
    elif spec.mode == "prefill":
        out["tokens"] = InputSpec((B, S), torch.int32)
    else:  # decode
        out["token"] = InputSpec((B,), torch.int32)
    if spec.mode in ("train", "prefill"):
        if cfg.family == "vlm":
            out["patch_embeds"] = InputSpec((B, cfg.n_patches, cfg.d_model),
                                            torch.bfloat16)
        if cfg.family == "encdec":
            out["frames"] = InputSpec((B, cfg.n_frames, cfg.d_model),
                                      torch.bfloat16)
    return out


def input_logical_axes(arch: str, shape: str) -> Dict[str, tuple]:
    """Logical axes for each input (its sharding in the dry-run)."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    out: Dict[str, tuple] = {}
    if spec.mode == "train":
        out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    elif spec.mode == "prefill":
        out = {"tokens": ("batch", "seq")}
    else:
        out = {"token": ("batch",)}
    if spec.mode in ("train", "prefill"):
        if cfg.family == "vlm":
            out["patch_embeds"] = ("batch", None, "act_embed")
        if cfg.family == "encdec":
            out["frames"] = ("batch", None, "act_embed")
    return out

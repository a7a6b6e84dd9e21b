"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM stacks;
family-specific fields are simply unused elsewhere.  Exact assigned configs
live in ``repro_torch/configs/<arch>.py``; reduced same-family configs for
smoke tests come from :meth:`ModelConfig.reduced`.  A copy of the JAX
package's ``models/config.py`` (it imports nothing of JAX), with fields of
the port's own (:data:`PORT_FIELDS`: the multipliers, the logits' divisor
and the position embedding of granite-4.0-h), each at a default that
leaves every configuration of the JAX package as it computes there, and
values of its own: ``"mamba"`` blocks in a hybrid's ``block_pattern`` and
``local_window=None`` (full attention).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


#: The fields that the JAX package's ``ModelConfig`` lacks, with their
#: neutral values.
PORT_FIELDS = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "attention_multiplier": None, "logits_scaling": 1.0,
               "position_embedding": "rope"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube)
    rope_theta: float = 10_000.0

    # mlp
    mlp_type: str = "swiglu"         # swiglu | squared_relu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # hybrid: block pattern of "rec" (RG-LRU, recurrentgemma), "mamba"
    # (Mamba-2 SSD, granite-4.0-h) and "attn" layers, each followed by an
    # MLP; the attention layers' window (None: full causal attention)
    rnn_width: Optional[int] = None
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_window: Optional[int] = 2048

    # enc-dec (whisper): encoder stack + stubbed frontend length
    n_enc_layers: int = 0
    n_frames: int = 1500             # precomputed frame embeddings (stub)

    # VLM: stubbed patch-embedding prefix length
    n_patches: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # The port's own (granite-4.0-h): the embedding's multiplier, each
    # mixer's and MLP's output's multiplier into the residual, the
    # attention's softmax scale (None: head_dim ** -0.5), the divisor of
    # the logits, and "rope" or "nope" (no position embedding)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    position_embedding: str = "rope"

    def __post_init__(self):
        # A pattern read from JSON arrives as a list.
        object.__setattr__(self, "block_pattern", tuple(self.block_pattern))

    # ---- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table and
        LM head shard evenly over a 16-wide TP axis (Megatron-style vocab
        padding; logits above ``vocab_size`` are masked to -inf)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width if self.rnn_width else self.d_model

    def block_types(self) -> Tuple[str, ...]:
        """Per-layer block kinds for hybrid stacks (pattern, truncated)."""
        if not self.block_pattern:
            return tuple(["attn"] * self.n_layers)
        reps = -(-self.n_layers // len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.n_layers])

    # ---- parameter counting (for 6ND MODEL_FLOPS and napkin math) ---------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        kinds = self.block_types()
        for kind in kinds if self.family == "hybrid" else ["x"] * self.n_layers:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            di, n, h = self.d_inner, self.ssm_state, self.n_ssm_heads
            ssm = (d * (2 * di + 2 * n + h) + di * d
                   + self.conv_width * (di + 2 * n))
            if self.family == "hybrid":
                r = self.rnn_width_
                blk = {"rec": 2 * d * r + r * d + 3 * r * r + r,
                       "mamba": ssm}.get(kind, attn)
                mlp = 3 * d * ff if self.mlp_type in ("swiglu", "gelu") else 2 * d * ff
                per_layer += blk + mlp
                continue
            if self.family == "ssm":
                per_layer += ssm
                continue
            mlp_mult = 3 if self.mlp_type == "swiglu" else 2
            if self.n_experts:
                e = self.top_k if active_only else self.n_experts
                mlp = e * mlp_mult * d * ff + d * self.n_experts
            else:
                mlp = mlp_mult * d * ff
            per_layer += attn + mlp
        enc = 0
        if self.n_enc_layers:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            mlp = (3 if self.mlp_type == "swiglu" else 2) * d * ff
            enc = self.n_enc_layers * (attn + mlp)
            # decoder cross-attention
            per_layer_cross = attn
            enc += self.n_layers * per_layer_cross
        return emb + per_layer + enc

    # ---- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        pattern = self.block_pattern
        n_layers = max(2, len(pattern)) if pattern else 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=96 if not self.n_experts else 32,
            vocab_size=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            rnn_width=64 if self.rnn_width else None,
            local_window=32 if self.local_window else None,
            sliding_window=32 if self.sliding_window else None,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_frames=24 if self.n_enc_layers else 1500,
            n_patches=8 if self.n_patches else 0,
        )

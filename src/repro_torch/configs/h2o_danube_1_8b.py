"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L, d_model=2560, 32 heads (GQA kv=8, head_dim=80), d_ff=6912, vocab=32000;
SWA window 4096 (mistral-style) => ring-buffer KV cache, sub-quadratic
long-context decode (runs the 524k cell).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6_912,
    vocab_size=32_000,
    mlp_type="swiglu",
    sliding_window=4_096,
    rope_theta=10_000.0,
)

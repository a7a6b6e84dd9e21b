"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm-2-12b].

40L, d_model=5120, 32 heads (GQA kv=8, head_dim=160), d_ff=13824,
vocab=100352; SwiGLU; per-head qk handled by standard RoPE.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
    mlp_type="swiglu",
    rope_theta=10_000.0,
)

"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads (GQA kv=4, head_dim=128 explicit), expert
d_ff=768, vocab=151936; 128 experts, top-8.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    mlp_type="swiglu",
    n_experts=128,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
)

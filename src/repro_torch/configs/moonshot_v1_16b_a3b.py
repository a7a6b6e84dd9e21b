"""moonshot-v1-16b-a3b — Moonlight-style MoE [hf:moonshotai/Moonlight-16B-A3B].

48L, d_model=2048, 16 heads (kv=16, head_dim=128), expert d_ff=1408,
vocab=163840; 64 experts, top-6 routing (capacity-based EP dispatch; the
checkpoint's 2 shared experts are out of the assigned figure set and
omitted — noted in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    mlp_type="swiglu",
    n_experts=64,
    top_k=6,
    capacity_factor=1.25,
    rope_theta=50_000.0,
)

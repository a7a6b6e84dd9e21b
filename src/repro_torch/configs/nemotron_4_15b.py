"""nemotron-4-15b — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

32L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), d_ff=24576,
vocab=256000; non-gated squared-ReLU MLP (2 weight matrices).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_type="squared_relu",
    rope_theta=10_000.0,
)

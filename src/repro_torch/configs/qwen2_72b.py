"""qwen2-72b — flagship dense GQA decoder with QKV bias [arXiv:2407.10671].

80L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=29568,
vocab=152064; SwiGLU; rope theta 1e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

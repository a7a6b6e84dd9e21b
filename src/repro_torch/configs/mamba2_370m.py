"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L, d_model=1024, ssm_state=128, vocab=50280; expand=2 => d_inner=2048,
head_dim=64 => 32 SSD heads; conv width 4; tied embeddings (mamba2 default).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,        # unused (attention-free)
    n_kv_heads=16,     # unused
    d_ff=0,            # attention-free: no MLP stack
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

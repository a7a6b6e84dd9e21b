"""granite-4.0-h-micro — Mamba-2 + full-attention hybrid (IBM Granite 4.0,
``granitemoehybrid``; huggingface.co/ibm-granite/granite-4.0-h-micro).

40L, d_model=2048: Mamba-2 at 36 layers (expand 2 => d_inner 4096, 64
heads of 64, state 128, one group, conv 4 with bias, chunk 256) and GQA
attention at layers 5, 15, 25 and 35 (32 query over 8 kv heads of 64, no
position embedding, softmax scale 1/64), every layer followed by a SwiGLU
MLP of 8192; the embedding x12, each mixer and MLP output x0.22 into the
residual, the logits / 8; vocab 100352, tied embeddings, RMSNorm eps 1e-5.
The port's own configuration: the JAX package has no Granite.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=100_352,
    mlp_type="swiglu",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    block_pattern=("mamba",) * 5 + ("attn",) + ("mamba",) * 4,
    local_window=None,
    tie_embeddings=True,
    norm_eps=1e-5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
    position_embedding="nope",
)

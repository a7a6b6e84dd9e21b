"""recurrentgemma-2b — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427].

26L, d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU),
vocab=256000; lru_width=2560, conv width 4, local window 2048; block
pattern (rec, rec, attn) => 8 full units + 2 remainder rec layers; tied
embeddings (gemma family).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_type="geglu",
    rnn_width=2560,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    conv_width=4,
    tie_embeddings=True,
)

"""internvl2-2b — InternViT + InternLM2-1.8B backbone [arXiv:2404.16821].

Assignment specifies the transformer BACKBONE only: 24L, d_model=2048,
16 heads (GQA kv=8), d_ff=8192, vocab=92553.  The ViT frontend is a STUB:
``input_specs()`` provides 256 precomputed patch embeddings (448px / 14
patch / 0.5 pixel-shuffle) that overwrite the first positions; labels are
masked there and the image prefix attends bidirectionally.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    n_patches=256,
)

"""whisper-base — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512, 8 heads (kv=8, head_dim=64),
d_ff=2048, vocab=51865; GELU MLP, LayerNorm, sinusoidal positions.  The
conv1d audio frontend is a STUB: ``input_specs()`` supplies 1500 precomputed
frame embeddings.  The assigned 32k decode shape far exceeds the real
model's 448-token context; we honor the assigned shape (DESIGN.md note).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    mlp_type="gelu",
    n_enc_layers=6,
    n_frames=1500,
)

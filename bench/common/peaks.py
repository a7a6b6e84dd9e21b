"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  A card set to a lower
limit reaches less; every result line carries the card's limit."""

#: bfloat16 / float16 tensor-core operations a second.
BF16_OPS = 989e12
#: HBM3 bytes a second.
HBM_BYTES = 3.35e12

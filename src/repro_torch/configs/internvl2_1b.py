"""InternVL2-1B [arXiv:2404.16821; hf].

VLM: InternViT frontend (STUB — input_specs provides precomputed patch
embeddings) + Qwen2-0.5B-class LM backbone: 24L, d_model=896, 14 heads
(GQA kv=2, head_dim=64), d_ff=4864, vocab=151655, tied embeddings.
256 patch embeddings are prepended to the text sequence.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    num_patches=256,
    tie_embeddings=True,
    rope_theta=1e6,
    microbatches_train_4k=2,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_patches=8,
    tie_embeddings=True,
    remat=False,
)

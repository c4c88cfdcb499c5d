"""Qwen3-32B [hf:Qwen/Qwen3-32B family].

64L dense, d_model=5120, 64 heads (GQA kv=8, head_dim=128), d_ff=25600,
vocab=151936, per-head qk-norm.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    microbatches_train_4k=8,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    qk_norm=True,
    remat=False,
)

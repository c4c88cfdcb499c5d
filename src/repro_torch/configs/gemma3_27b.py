"""Gemma-3 27B [hf:google/gemma-3-27b-pt; unverified tier].

62L dense with 5:1 local:global interleave (window 1024; local RoPE θ=1e4,
global θ=1e6), d_model=5376, 32 heads (GQA kv=16, head_dim=128),
d_ff=21504, vocab=262144, qk-norm, √d embedding scale.
62 = 10 whole (5L+1G) groups + 2 trailing local layers.
"""

import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    local_window=1024,
    rope_theta=1e6,
    rope_theta_local=1e4,
    qk_norm=True,
    embed_scale=math.sqrt(5376.0),
    tie_embeddings=True,
    microbatches_train_4k=8,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=8,                  # 1 whole group + 2 tail locals
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    local_window=16,
    rope_theta=1e6,
    rope_theta_local=1e4,
    qk_norm=True,
    embed_scale=8.0,
    tie_embeddings=True,
    remat=False,
)

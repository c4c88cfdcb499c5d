"""Mamba2-1.3B (SSD, state-space duality) [arXiv:2405.21060; unverified].

48L attention-free SSM: d_model=2048, d_inner=4096 (expand 2),
64 SSD heads × head_dim 64, state=128, conv width 4, chunk 256,
vocab=50280.  Owns the long_500k cell (O(1)-state decode).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    attention="none",
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    chunk_size=256,
    tie_embeddings=True,
    microbatches_train_4k=1,
    prefer_pure_dp=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    layer_pattern=("ssm",),
    attention="none",
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_expand=2,
    conv_width=4,
    chunk_size=32,
    tie_embeddings=True,
    remat=False,
)

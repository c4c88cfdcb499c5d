"""IBM Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base].

40L dense, d_model=2048, 32 heads (GQA kv=8, head_dim=64), d_ff=8192,
vocab=49155, tied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=1e4,
    microbatches_train_4k=1,
    prefer_pure_dp=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    remat=False,
)

"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

26L hybrid, pattern (RG-LRU, RG-LRU, local-MQA) — 1:2 attention:recurrence.
d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU-style
SwiGLU here), lru_width=2560, local window 2048, vocab=256000.
26 = 8 whole groups + 2 trailing RG-LRU layers.
"""

import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=1e4,
    embed_scale=math.sqrt(2560.0),
    tie_embeddings=True,
    microbatches_train_4k=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,                   # 1 group + 2 tail rglru
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=16,
    lru_width=64,
    conv_width=4,
    embed_scale=8.0,
    tie_embeddings=True,
    remat=False,
)

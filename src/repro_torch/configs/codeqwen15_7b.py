"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

32L dense (qwen1.5 arch), d_model=4096, 32 heads (kv=32 → MHA,
head_dim=128), d_ff=13440, vocab=92416.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1e6,
    microbatches_train_4k=4,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    remat=False,
)

"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

60L, d_model=5120, 128 MLA heads (kv_lora=512), MoE 2 shared + 160 routed
top-6 (expert d_ff=1536), first layer dense (d_ff=12288), vocab 102400.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,
    d_ff=12288,                   # the leading dense layer
    vocab_size=102400,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
    rope_theta=1e4,
    microbatches_train_4k=8,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=24,
    d_ff=128,
    vocab_size=256,
    attention="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
    num_experts=8,
    num_shared_experts=2,
    top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    remat=False,
)

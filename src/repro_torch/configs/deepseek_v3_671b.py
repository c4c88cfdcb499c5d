"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

61L, d_model=7168, 128 MLA heads, MoE 1 shared + 256 routed top-8
(expert d_ff=2048), first 3 layers dense (d_ff=18432), MTP depth 1,
vocab 129280.  MLA: q_lora=1536, kv_lora=512, rope=64, nope=128, v=128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,                 # nope(128) + rope(64)
    d_ff=18432,                   # the 3 leading dense layers
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_k_dense=3,
    mtp_depth=1,
    rope_theta=1e4,
    microbatches_train_4k=8,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
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
    num_shared_experts=1,
    top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    mtp_depth=1,
    remat=False,
)

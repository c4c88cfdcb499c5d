"""Whisper-large-v3 [arXiv:2212.04356; unverified tier].

Enc-dec: 32 encoder + 32 decoder layers, d_model=1280, 20 heads (MHA,
head_dim=64), d_ff=5120, vocab=51866, absolute sinusoidal positions,
decoder context 448.  Conv frontend is a STUB — input_specs provides
precomputed frame embeddings; the 32k/500k shape lengths live in the
cross-attention KV (encoder frames).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                 # per assignment: 32L backbone
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    enc_layers=32,
    dec_layers=32,
    max_decode_len=448,
    pos_embedding="absolute",
    microbatches_train_4k=4,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    is_encoder_decoder=True,
    enc_layers=2,
    dec_layers=2,
    max_decode_len=32,
    pos_embedding="absolute",
    remat=False,
)

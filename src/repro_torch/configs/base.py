"""ModelConfig — one dataclass drives every architecture in the zoo.

Each assigned architecture gets a module in this package defining
``CONFIG`` (the exact published geometry) and ``SMOKE`` (a reduced config of
the same family for CPU tests).  ``registry()`` maps ``--arch`` ids to them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = (
    "deepseek_v3_671b",
    "deepseek_v2_236b",
    "granite_3_2b",
    "codeqwen15_7b",
    "qwen3_32b",
    "gemma3_27b",
    "recurrentgemma_2b",
    "internvl2_1b",
    "mamba2_13b",
    "whisper_large_v3",
)

# Input-shape suite shared by every LM arch (assignment table).
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer stacking: the repeating unit (scanned); kinds:
    #   "global" (full attn) | "local" (sliding window) | "rglru" | "ssm"
    layer_pattern: tuple = ("global",)

    # attention flavor
    attention: str = "gqa"           # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_local: Optional[float] = None
    local_window: int = 0

    # MLA (DeepSeek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256

    # RG-LRU
    lru_width: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    dec_layers: int = 0
    max_decode_len: int = 448

    # VLM stub frontend
    num_patches: int = 0

    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    mtp_weight: float = 0.3

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    pos_embedding: str = "rope"      # rope | absolute (whisper)
    embed_scale: float = 1.0         # gemma: sqrt(d_model)
    # memory-efficient attention: query-block size (0 = unblocked).  Blocks
    # are unrolled (not scanned) so cost_analysis counts their FLOPs.
    attn_q_block: int = 1024
    # Unroll the layer-group scan (cost-measurement variants only: XLA's
    # cost_analysis counts a while body once, so the roofline 1g/2g compiles
    # must not scan).  Production configs keep the scan for compile time.
    unroll_groups: bool = False
    # Pure-DP mapping for small models (§Perf iter 8): batch shards over the
    # WHOLE mesh (incl. "model"), params replicate over "model" (vocab dim
    # excepted) — per-layer TP all-reduces vanish; the only large collective
    # left is the per-step grad reduction.  Right when bf16 params fit one
    # chip comfortably (≤ ~3B params).
    prefer_pure_dp: bool = False

    # training-time knobs (used by launch/, not by model math)
    remat: bool = True
    microbatches_train_4k: int = 1
    logit_softcap: float = 0.0

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple when it doesn't already divide
        the 16-way model axis — unlocks vocab sharding of embeddings and
        logits (a ~20 GB/device lever at 4k×256; see EXPERIMENTS.md §Perf).
        Pad logit columns are masked to −inf in the LM head."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid — O(1)-state decode)."""
        return self.family in ("ssm", "hybrid")

    @property
    def pattern_layers(self) -> tuple:
        """Per-layer kinds for the full stack: pattern repeated + truncated."""
        reps = -(-self.num_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.num_layers]

    @property
    def num_groups(self) -> int:
        """Whole repetitions of the pattern (the scanned trip count)."""
        return self.num_layers // len(self.layer_pattern)

    @property
    def tail_layers(self) -> tuple:
        """Layers past the last whole group (unrolled separately)."""
        return self.pattern_layers[self.num_groups * len(self.layer_pattern):]

    def supports_shape(self, shape: str) -> tuple[bool, str]:
        """(runnable, reason-if-skipped) for an assignment shape id."""
        if shape == "long_500k" and not self.sub_quadratic:
            return False, ("full-attention family: 500k-token decode needs "
                           "sub-quadratic attention (DESIGN.md §7)")
        return True, ""


def load_arch(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.CONFIG


def load_smoke(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.SMOKE


def registry() -> dict:
    return {a: load_arch(a) for a in ARCH_IDS}

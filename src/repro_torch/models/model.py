"""build_model(cfg) — the single constructor the CLIs, tests and smoke use."""

from __future__ import annotations

from .encdec import EncDecLM
from .transformer import DecoderLM


def build_model(cfg, device="cuda") -> DecoderLM | EncDecLM:
    """The port's model for ``cfg`` on ``device``, parameters allocated
    but not initialised (``.init(generator)`` or the converter fill
    them): ``EncDecLM`` for an encoder-decoder config, else
    ``DecoderLM``."""
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)

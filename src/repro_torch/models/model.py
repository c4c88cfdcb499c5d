"""build_model(cfg) — the single constructor the CLIs, tests and smoke use."""

from __future__ import annotations

from .transformer import DecoderLM


def build_model(cfg, device="cuda") -> DecoderLM:
    """The port's model for ``cfg`` on ``device``, parameters allocated
    but not initialised (``.init(generator)`` or the converter fill
    them).  Raises ``NotImplementedError`` for a family the port lacks."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) is an encoder-decoder: "
            f"models/encdec.py is not ported to PyTorch yet")
    return DecoderLM(cfg, device)

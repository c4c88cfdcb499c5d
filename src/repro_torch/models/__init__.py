"""Model zoo on PyTorch: the dense GQA decoders of the JAX package's zoo."""

from .model import build_model  # noqa: F401

"""Model zoo on PyTorch: the dense, hybrid, SSM and encoder-decoder LMs
of the JAX package's zoo (MoE and MLA not yet)."""

from .model import build_model  # noqa: F401

"""Architecture configs: one module per assigned arch (+ smoke variants).

A data-only copy of the JAX package's ``configs/``: the same ``ModelConfig``
fields, ``ARCH_IDS``, ``SHAPES`` and published geometries, so the port never
imports the reference to learn a model's shape.
"""

from .base import ARCH_IDS, SHAPES, ModelConfig, load_arch, load_smoke, registry  # noqa: F401

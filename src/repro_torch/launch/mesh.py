"""Production meshes (the reference's geometry) as ``DeviceMesh``es.

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model").

The port of the JAX package's ``launch/mesh.py``.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, which the caller initialises (``dryrun`` over a
``FakeStore`` with the ``"fake"`` backend, the launcher over the cards it
sees).  Building a mesh never initialises a process group.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import init_device_mesh

# NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's H100 Tensor Core GPU
# datasheet: dense bf16 Tensor Core peak, HBM3 bandwidth, and NVLink 4's
# 900 GB/s per GPU counted per direction.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s per card, one direction
HBM_BYTES = 80e9                # device memory per card

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(multi_pod: bool = False, device_type=None):
    """The 16×16 (or 2×16×16) mesh over the default process group, which
    must have exactly that many ranks."""
    import torch.distributed as dist
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise SystemExit(f"the production mesh {'×'.join(map(str, shape))} "
                         f"needs {need} ranks; found {have}")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_local_mesh(shape=None, axes=None, device_type=None):
    """A mesh over the ranks of the default process group: ``(world,)``
    ``("data",)`` unless ``shape``/``axes`` say otherwise.  On the cards
    unless ``device_type="cpu"`` is asked for."""
    import torch.distributed as dist
    if shape is None:
        shape, axes = (dist.get_world_size(),), ("data",)
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))

"""Device-side bounds helpers shared by the device backend.

The JAX package's module of the same name holds the mesh engine's sharded
step functions; those come with the mesh slice.  What the single-device
backend needs from it are three plain tensor operations — no kernels:

* :func:`value_ks` — the host-side value-edge resolution of a bounds pass;
* :func:`device_resolve` — pixel ROIs → grid corners, on the device;
* :func:`_bounds_from_corners` — the 8-corner CHI lookup from those corners.
"""

from __future__ import annotations

import numpy as np
import torch

from . import chi as chi_lib


def _bounds_from_corners(table, corners, area, kl_in, ku_in, kl_out, ku_out):
    """Same 8-corner math as chi._bounds_device, but with corner indices as
    device tensors (computed on device from boundary tables) so the whole
    bounds pass stays on the device.  The value-edge indices are Python
    ints."""
    il, ih, jl, jh, ol, oh, pl, ph = [corners[:, i] for i in range(8)]
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    inner_ok = (ih > il) & (jh > jl) & (ku_in > kl_in)
    lb = torch.where(inner_ok,
                     chi_lib._lookup(table, il, ih, jl, jh,
                                     min(kl_in, ku_in), ku_in), zero)
    outer_ok = (oh > ol) & (ph > pl) & (ku_out > kl_out)
    ub = torch.where(outer_ok,
                     chi_lib._lookup(table, ol, oh, pl, ph,
                                     min(kl_out, ku_out), ku_out), zero)
    ub = torch.minimum(ub, area.to(ub.dtype))
    lb = torch.minimum(lb, ub)
    return lb.to(torch.int32), ub.to(torch.int32)


def device_resolve(rois, row_bounds, col_bounds):
    """Device-side resolve_query: map pixel ROIs onto grid corners.

    rois (N, 4) int32; boundary tables (G+1,) int32 (tiny).
    Returns corners (N, 8) int64 + area (N,) int32.
    """
    r0, c0, r1, c1 = (rois[:, i].contiguous() for i in range(4))

    def ss(bounds, x, right):
        return torch.searchsorted(bounds, x, right=right)

    il = ss(row_bounds, r0, False)
    ih = ss(row_bounds, r1, True) - 1
    jl = ss(col_bounds, c0, False)
    jh = ss(col_bounds, c1, True) - 1
    ol = ss(row_bounds, r0, True) - 1
    oh = ss(row_bounds, r1, False)
    pl = ss(col_bounds, c0, True) - 1
    ph = ss(col_bounds, c1, False)
    g = row_bounds.shape[0] - 1
    corners = torch.stack([il, ih, jl, jh, ol, oh, pl, ph], dim=1)
    corners = corners.clamp(0, g)
    area = ((r1 - r0).clamp(min=0) * (c1 - c0).clamp(min=0)).to(torch.int32)
    return corners, area


def value_ks(cfg: chi_lib.CHIConfig, lv: float, uv: float) -> np.ndarray:
    """Resolve a value range onto CHI bin edges as the 4-vector
    ``[kl_in, ku_in, kl_out, ku_out]`` (inner/outer threshold-prefix
    indices) — the host-side half of a device bounds pass.  Matches
    :func:`repro_torch.core.chi.resolve_query`'s value resolution exactly."""
    edges = cfg.edges
    kl_in = np.searchsorted(edges, lv, side="left")
    ku_in = np.searchsorted(edges, uv, side="right") - 1
    kl_out = np.searchsorted(edges, lv, side="right") - 1
    ku_out = np.searchsorted(edges, uv, side="left")
    return np.clip(np.array([kl_in, ku_in, kl_out, ku_out], dtype=np.int32),
                   0, cfg.num_bins)

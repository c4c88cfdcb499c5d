"""Mask generation — the "masks come from models" half of the workflow.

The port of the JAX package's ``core/saliency.py``.  The demo's masks are
model saliency maps (Grad-CAM-style) and object-detector boxes.  Mask
sources, per architecture family (DESIGN.md §7):

  * **attention rollout** for transformer LMs — per-layer attention maps
    multiplied through the residual stream (Abnar & Zuidema), giving a
    (S × S) float mask per example;
  * **last-layer attention maps** (cheaper; head-averaged);
  * **input-gradient saliency** for any differentiable model —
    |∂loss/∂embedding| reduced over features, reshaped to a 2-D grid;
  * **expert-utilization maps** for MoE: (tokens × experts) routing heat
    map.

Every source normalizes into the paper's data model: 2-D float tensors in
[0, 1), ready for CHI ingest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normalize01(mask: torch.Tensor, axis=(-2, -1)) -> torch.Tensor:
    """Affinely map each mask to [0, 1) (per-mask min/max, ε-shrunk so the
    max stays strictly below 1 — the paper's value domain)."""
    lo = torch.amin(mask, dim=axis, keepdim=True)
    hi = torch.amax(mask, dim=axis, keepdim=True)
    out = (mask - lo) / torch.clamp(hi - lo, min=1e-12)
    return out * (1.0 - 1e-6)


def attention_rollout(attn: torch.Tensor) -> torch.Tensor:
    """Attention rollout over a layer stack.

    Args:
      attn: (L, B, heads, S, S) post-softmax attention.
    Returns:
      (B, S, S) rollout masks in [0, 1).
    """
    a = attn.mean(dim=2)                              # head-average: (L,B,S,S)
    s = a.shape[-1]
    eye = torch.eye(s, dtype=a.dtype, device=a.device)
    a = 0.5 * a + 0.5 * eye                           # residual connection
    a = a / a.sum(dim=-1, keepdim=True)
    out = eye.expand(a.shape[1:])
    for layer in a:                                   # in layer order
        out = layer @ out
    return normalize01(out)


def last_layer_attention(attn_last: torch.Tensor) -> torch.Tensor:
    """(B, heads, S, S) → (B, S, S) head-averaged map in [0, 1)."""
    return normalize01(attn_last.mean(dim=1))


def input_saliency(loss_fn, params, batch) -> torch.Tensor:
    """|∂loss/∂embeddings| saliency (works for every differentiable arch).

    ``loss_fn(params, batch, embeddings) -> scalar`` where ``embeddings``
    is the (B, S, D) input-embedding tensor the model consumes (taken
    from ``batch["embeddings"]``).  Returns (B, S) per-token scores in
    [0, 1)."""
    emb = batch["embeddings"].detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(loss_fn(params, batch, emb), emb)
    scores = torch.linalg.vector_norm(g, dim=-1)      # (B, S)
    return normalize01(scores, axis=(-1,))


def tokens_to_grid(scores: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Arrange (B, S) per-token scores into (B, height, width) masks.

    Tokens fill the grid row-major; short sequences pad with 0, long ones
    average-pool.  This is the canonical "LM tokens as a 2-D mask" layout
    the query engine indexes.
    """
    b, s = scores.shape
    cells = height * width
    if s >= cells:
        # average-pool s → cells
        x = F.pad(scores, (0, (-s) % cells))
        x = x.reshape(b, cells, -1).mean(-1)
    else:
        x = F.pad(scores, (0, cells - s))
    return x.reshape(b, height, width)


def resize_mask(mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resize arbitrary 2-D maps (B, h, w) onto the store's
    canonical (H, W).  Antialiased, as ``jax.image.resize(...,
    "bilinear")`` is when it shrinks."""
    return F.interpolate(mask[:, None], size=(height, width),
                         mode="bilinear", align_corners=False,
                         antialias=True)[:, 0]


def expert_utilization_map(router_probs: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """MoE routing heat map: (B, S, E) router probabilities → per-example
    (H, W) mask (tokens × experts resized).  A MaskSearch client unique to
    MoE archs: 'find batches whose expert load is most skewed' is a CP
    query over these masks."""
    return normalize01(resize_mask(router_probs, height, width))

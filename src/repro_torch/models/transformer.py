"""Decoder LM: the dense, hybrid and SSM stacks of the zoo on PyTorch.

The port of the JAX package's ``models/transformer.py`` for stacks of
``"global"``/``"local"`` GQA blocks with a SwiGLU FFN (granite, codeqwen,
qwen3, gemma3, internvl2 with patch embeddings prepended), ``"rglru"``
recurrent blocks with the same FFN (recurrentgemma's hybrid) and
``"ssm"`` Mamba-2 blocks with no FFN (mamba2).  The reference's stacked,
scanned layer groups and unrolled tail become an ``nn.ModuleList`` of
one block per layer, in the order of ``cfg.pattern_layers``.

Families whose modules are not ported yet — MoE FFNs, MLA attention, the
MTP head — raise ``NotImplementedError`` naming the family; nothing falls
back to another block.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .layers import (DTYPES, Params, cross_entropy, embed, init_rms,
                     logits_from_tied, param, remat_call, rms_norm,
                     sinusoidal_positions, swiglu)

ATTENTION = ("global", "local")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    missing = []
    if cfg.num_experts > 0:
        missing.append("MoE FFN (models/moe.py)")
    if cfg.attention == "mla":
        missing.append("MLA attention (models/mla.py)")
    if cfg.mtp_depth:
        missing.append("the multi-token-prediction head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) needs {', '.join(missing)}, "
            f"which the PyTorch port does not have yet")


class Block(torch.nn.Module):
    """One pre-norm block: ``ln1`` → mixer → residual, then (all kinds but
    ``"ssm"``) ``ln2`` → SwiGLU (``ffn``) → residual.  The mixer is GQA
    attention for ``"global"``/``"local"``, RG-LRU for ``"rglru"`` and
    Mamba-2 for ``"ssm"``.  Parameter names are the reference's, so its
    per-layer param tree maps onto ``state_dict``."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = init_rms(cfg.d_model, device)
        if kind in ATTENTION:
            self.mixer = attn.Attention(cfg, dtype, device)
        elif kind == "rglru":
            self.mixer = Params(rglru_lib.rglru_spec(cfg, dtype), device)
        elif kind == "ssm":
            self.mixer = Params(ssm_lib.ssm_spec(cfg, dtype), device)
        else:
            raise ValueError(kind)
        if kind != "ssm":
            self.ln2 = init_rms(cfg.d_model, device)
            d, f = cfg.d_model, cfg.d_ff
            self.ffn = Params({"gate": ((d, f), dtype, "fan_in"),
                               "up": ((d, f), dtype, "fan_in"),
                               "down": ((f, d), dtype, "fan_in")}, device)

    def init(self, generator) -> None:
        self.mixer.init(generator)
        if self.kind != "ssm":
            self.ffn.init(generator)

    def _ffn(self, x):
        if self.kind == "ssm":
            return x
        return x + swiglu(self.ffn, rms_norm(x, self.ln2, self.cfg.norm_eps))

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Training-path block (the reference's ``apply_block``)."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.kind in ATTENTION:
            h = attn.attention(self.mixer, cfg, h, positions, self.kind)
        elif self.kind == "rglru":
            h = rglru_lib.rglru_block(self.mixer, cfg, h)
        else:
            h = ssm_lib.ssm_block(self.mixer, cfg, h)
        return self._ffn(x + h)

    def init_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        """``{"k", "v"}`` for attention, ``{"h", "conv"}`` for RG-LRU,
        ``{"state", "conv"}`` for SSM (states in f32)."""
        if self.kind in ATTENTION:
            return attn.init_cache(self.cfg, batch, max_len, self.kind,
                                   dtype, device)
        if self.kind == "rglru":
            return rglru_lib.init_rglru_cache(self.cfg, batch, dtype, device)
        return ssm_lib.init_ssm_cache(self.cfg, batch, dtype, device)

    def prefill(self, x, positions, cache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.kind in ATTENTION:
            h, cache = attn.prefill_attention(self.mixer, cfg, h, positions,
                                              self.kind, cache)
        elif self.kind == "rglru":
            h, cache = rglru_lib.rglru_prefill(self.mixer, cfg, h, cache)
        else:
            h, cache = ssm_lib.ssm_prefill(self.mixer, cfg, h, cache)
        return self._ffn(x + h), cache

    def decode(self, x, pos: int, cache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.kind in ATTENTION:
            h, cache = attn.decode_attention(self.mixer, cfg, h, pos,
                                             self.kind, cache)
        elif self.kind == "rglru":
            h, cache = rglru_lib.rglru_decode(self.mixer, cfg, h, cache)
        else:
            h, cache = ssm_lib.ssm_decode(self.mixer, cfg, h, cache)
        return self._ffn(x + h), cache


class DecoderLM(torch.nn.Module):
    """Decoder LM on ``device``.  Construction allocates the parameters
    uninitialised; fill them with :meth:`init` (random, from a generator)
    or :func:`~repro_torch.models.convert.load_reference_params`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.device = torch.device(device)
        self.kinds = tuple(cfg.pattern_layers)
        self.embedding = torch.nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=self.dtype,
            device=self.device))
        self.final_norm = init_rms(cfg.d_model, self.device)
        self.blocks = torch.nn.ModuleList(
            Block(cfg, kind, self.dtype, self.device) for kind in self.kinds)

    # -- init ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random init from ``generator`` (a generator on the model's
        device): embedding rows truncated normal at scale 1, projections
        at fan-in scale, norms zero (identity).  Returns the model."""
        self.embedding = param(generator, tuple(self.embedding.shape),
                               dtype=self.dtype, device=self.device,
                               scale=1.0)
        for blk in self.blocks:
            blk.init(generator)
        return self

    # -- forward (train) ------------------------------------------------------

    def _inputs(self, batch):
        """Token (+ optional patch) embeddings and positions."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = embed(self.embedding, tokens) * torch.tensor(
            cfg.embed_scale, dtype=self.dtype)
        if cfg.num_patches and "patches" in batch:
            patches = torch.as_tensor(batch["patches"],
                                      device=self.device).to(self.dtype)
            x = torch.cat([patches, x], dim=1)
        if cfg.pos_embedding == "absolute":
            pe = torch.as_tensor(sinusoidal_positions(x.shape[1],
                                                      cfg.d_model),
                                 device=self.device).to(self.dtype)
            x = x + pe[None]
        positions = torch.arange(x.shape[1], device=self.device)
        return x, positions.expand(x.shape[0], -1)

    def hidden_states(self, batch):
        """Full stack forward → (h (B,S,D), aux_loss).  With ``cfg.remat``
        and autograd recording, each block recomputes its activations in
        the backward pass (the reference's ``jax.checkpoint``)."""
        x, positions = self._inputs(batch)
        for blk in self.blocks:
            x = remat_call(self.cfg, blk, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def logits(self, batch):
        h, aux = self.hidden_states(batch)
        return logits_from_tied(self.embedding, h, self.cfg.vocab_size), aux

    def loss(self, batch):
        """batch: tokens (B,S), labels (B,S) [-1 = pad] (+ patches for VLM).

        Returns (loss, metrics-dict).  VLM: labels cover text positions
        only; patch positions are prepended and excluded."""
        cfg = self.cfg
        h, aux = self.hidden_states(batch)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if cfg.num_patches and "patches" in batch:
            h = h[:, -labels.shape[1]:]
        logits = logits_from_tied(self.embedding, h, cfg.vocab_size)
        ce = cross_entropy(logits, labels)
        total = ce + aux
        return total, {"ce": ce, "aux": aux, "loss": total}

    # -- serving ----------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> list:
        """One zeroed cache per layer, of its kind (``Block.init_cache``)."""
        return [blk.init_cache(batch, max_len, self.dtype, self.device)
                for blk in self.blocks]

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Consume the prompt; → (last-position logits (B,1,V), cache)."""
        x, positions = self._inputs(batch)
        for i, blk in enumerate(self.blocks):
            x, cache[i] = blk.prefill(x, positions, cache[i])
        h = rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        return logits_from_tied(self.embedding, h, self.cfg.vocab_size), cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One token for the whole batch.  token: (B, 1) ints, pos: the
        absolute position it takes."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device).long()
        x = embed(self.embedding, token) * torch.tensor(cfg.embed_scale,
                                                        dtype=self.dtype)
        for i, blk in enumerate(self.blocks):
            x, cache[i] = blk.decode(x, int(pos), cache[i])
        h = rms_norm(x, self.final_norm, cfg.norm_eps)
        return logits_from_tied(self.embedding, h, cfg.vocab_size), cache

    # -- mask extraction (MaskSearch integration) ------------------------------

    @torch.no_grad()
    def attention_maps(self, batch):
        """Post-softmax attention of the *last attention layer* (the last
        ``"global"``/``"local"`` block, which in a hybrid stack need not be
        the last block), for the mask DB: the blocks before it run, then
        its scores are recomputed and softmaxed in f32.  Returns
        (B, heads, S, S) float32, or ``None`` for an attention-free
        stack."""
        cfg = self.cfg
        layers = [i for i, k in enumerate(self.kinds) if k in ATTENTION]
        if not layers:
            return None
        x, positions = self._inputs(batch)
        last = layers[-1]
        for blk in self.blocks[:last]:
            x = blk(x, positions)
        blk = self.blocks[last]
        q, k, _ = attn._qkv(blk.mixer, cfg, rms_norm(x, blk.ln1,
                                                     cfg.norm_eps),
                            positions, blk.kind)
        s, hq = q.shape[1], q.shape[2]
        scores = attn.map_scores(q, attn.repeat_kv(k, hq // k.shape[2]))
        mask = attn.causal_mask(s, s, 0, cfg.local_window
                                if blk.kind == "local" else 0, self.device)
        scores = scores.masked_fill(~mask, attn.NEG_INF)
        return torch.softmax(scores, dim=-1)

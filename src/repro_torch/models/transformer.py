"""Decoder LM: the dense GQA stacks of the zoo on PyTorch.

The port of the JAX package's ``models/transformer.py`` for stacks of
``"global"``/``"local"`` GQA blocks with a SwiGLU FFN: granite, codeqwen,
qwen3, gemma3 and internvl2 (patch embeddings prepended).  The
reference's stacked, scanned layer groups become an ``nn.ModuleList`` of
one block per layer, in the order of ``cfg.pattern_layers``.

Families whose mixers are not ported yet — MoE FFNs, MLA attention,
RG-LRU and SSM blocks, the MTP head — raise ``NotImplementedError``
naming the family; nothing falls back to another block.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import (cross_entropy, embed, init_rms, logits_from_tied,
                     param, rms_norm, sinusoidal_positions, swiglu)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    missing = []
    if cfg.num_experts > 0:
        missing.append("MoE FFN (models/moe.py)")
    if cfg.attention == "mla":
        missing.append("MLA attention (models/mla.py)")
    for kind, module in (("rglru", "models/rglru.py"),
                         ("ssm", "models/ssm.py")):
        if kind in cfg.pattern_layers:
            missing.append(f"{kind} blocks ({module})")
    if cfg.mtp_depth:
        missing.append("the multi-token-prediction head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) needs {', '.join(missing)}, "
            f"which the PyTorch port does not have yet")


class Block(torch.nn.Module):
    """One pre-norm GQA block: ``ln1`` → attention (``mixer``) → residual,
    ``ln2`` → SwiGLU (``ffn``) → residual.  Parameter names are the
    reference's, so its per-layer param tree maps onto ``state_dict``."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = init_rms(cfg.d_model, device)
        self.mixer = attn.Attention(cfg, dtype, device)
        self.ln2 = init_rms(cfg.d_model, device)
        empty = dict(dtype=dtype, device=device)
        d, f = cfg.d_model, cfg.d_ff
        self.ffn = torch.nn.ParameterDict({
            "gate": torch.empty((d, f), **empty),
            "up": torch.empty((d, f), **empty),
            "down": torch.empty((f, d), **empty)})

    def init(self, generator) -> None:
        self.mixer.init(generator)
        for name, w in list(self.ffn.items()):
            self.ffn[name] = param(generator, tuple(w.shape), dtype=w.dtype,
                                   device=w.device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Training-path block (the reference's ``apply_block``)."""
        cfg = self.cfg
        h = attn.attention(self.mixer, cfg, rms_norm(x, self.ln1,
                                                     cfg.norm_eps),
                           positions, self.kind)
        x = x + h
        return x + swiglu(self.ffn, rms_norm(x, self.ln2, cfg.norm_eps))

    def prefill(self, x, positions, cache):
        cfg = self.cfg
        h, cache = attn.prefill_attention(
            self.mixer, cfg, rms_norm(x, self.ln1, cfg.norm_eps), positions,
            self.kind, cache)
        x = x + h
        return x + swiglu(self.ffn, rms_norm(x, self.ln2, cfg.norm_eps)), \
            cache

    def decode(self, x, pos: int, cache):
        cfg = self.cfg
        h, cache = attn.decode_attention(
            self.mixer, cfg, rms_norm(x, self.ln1, cfg.norm_eps), pos,
            self.kind, cache)
        x = x + h
        return x + swiglu(self.ffn, rms_norm(x, self.ln2, cfg.norm_eps)), \
            cache


class DecoderLM(torch.nn.Module):
    """Decoder LM on ``device``.  Construction allocates the parameters
    uninitialised; fill them with :meth:`init` (random, from a generator)
    or :func:`~repro_torch.models.convert.load_reference_params`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
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
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint(blk, x, positions, use_reentrant=False)
                 if remat else blk(x, positions))
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
        """One zeroed ``{"k", "v"}`` cache per layer."""
        return [attn.init_cache(self.cfg, batch, max_len, kind, self.dtype,
                                self.device) for kind in self.kinds]

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
        """Post-softmax attention of the *last* attention layer, for the
        mask DB: the blocks before it run, then its scores are recomputed
        and softmaxed in f32.  Returns (B, heads, S, S) float32."""
        cfg = self.cfg
        x, positions = self._inputs(batch)
        last = len(self.blocks) - 1
        for blk in self.blocks[:last]:
            x = blk(x, positions)
        blk = self.blocks[last]
        q, k, _ = attn._qkv(blk.mixer, cfg, rms_norm(x, blk.ln1,
                                                     cfg.norm_eps),
                            positions, blk.kind)
        b, s, hq, d = q.shape
        k = attn.repeat_kv(k, hq // k.shape[2])
        # the product and the ÷ sqrt(D) in the compute dtype, as the
        # reference divides by a weakly typed scalar before the f32 cast
        scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
        scores = scores / torch.tensor(attn.sqrt_f32(d), dtype=scores.dtype)
        mask = attn.causal_mask(s, s, 0, cfg.local_window
                                if blk.kind == "local" else 0, self.device)
        scores = scores.float().masked_fill(~mask, attn.NEG_INF)
        return torch.softmax(scores, dim=-1)

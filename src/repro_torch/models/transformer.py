"""Decoder LM: every decoder stack of the zoo on PyTorch.

The port of the JAX package's ``models/transformer.py`` for stacks of
``"global"``/``"local"`` attention blocks with a SwiGLU FFN (granite,
codeqwen, qwen3, gemma3, internvl2 with patch embeddings prepended),
``"rglru"`` recurrent blocks with the same FFN (recurrentgemma's hybrid),
``"ssm"`` Mamba-2 blocks with no FFN (mamba2), and DeepSeek's stacks:
MLA attention (``cfg.attention == "mla"``), a dense prefix of
``first_k_dense`` layers and MoE FFNs after it, and V3's
multi-token-prediction head.  The reference's dense prefix, stacked and
scanned layer groups and unrolled tail (``stack_plan``) become an
``nn.ModuleList`` of one block per layer, in the order of
``cfg.pattern_layers``.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mla as mla_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .layers import (DTYPES, Params, cross_entropy, embed, empty, init_rms,
                     logits_from_tied, mlp_spec, redraw, remat_call, rms_norm,
                     shard_act, sinusoidal_positions, swiglu)

ATTENTION = ("global", "local")


def stack_plan(cfg) -> tuple:
    """The reference's ``_stack_plan``: (prefix kinds, group kinds, number
    of groups, tail kinds).  The prefix is the ``first_k_dense`` dense
    layers of an MoE stack; the groups repeat ``cfg.layer_pattern`` over
    the layers after it; the tail is what remains."""
    kinds = list(cfg.pattern_layers)
    nprefix = cfg.first_k_dense if cfg.num_experts > 0 else 0
    rest = kinds[nprefix:]
    glen = len(cfg.layer_pattern)
    n_groups = len(rest) // glen
    return (tuple(kinds[:nprefix]), tuple(cfg.layer_pattern), n_groups,
            tuple(rest[n_groups * glen:]))


class Block(torch.nn.Module):
    """One pre-norm block: ``ln1`` → mixer → residual, then (all kinds but
    ``"ssm"``) ``ln2`` → FFN → residual.  The mixer is attention for
    ``"global"``/``"local"`` (GQA, or MLA when ``cfg.attention ==
    "mla"``), RG-LRU for ``"rglru"`` and Mamba-2 for ``"ssm"``; the FFN
    is the MoE with ``use_moe``, else a SwiGLU.  Parameter names are the
    reference's, so its per-layer param tree maps onto ``state_dict``."""

    def __init__(self, cfg, kind: str, dtype, device, use_moe: bool = False):
        super().__init__()
        self.cfg, self.kind, self.use_moe = cfg, kind, use_moe
        self.mla = kind in ATTENTION and cfg.attention == "mla"
        self.ln1 = init_rms(cfg.d_model, device)
        if self.mla:
            self.mixer = Params(mla_lib.mla_spec(cfg, dtype), device)
        elif kind in ATTENTION:
            self.mixer = attn.Attention(cfg, dtype, device)
        elif kind == "rglru":
            self.mixer = Params(rglru_lib.rglru_spec(cfg, dtype), device)
        elif kind == "ssm":
            self.mixer = Params(ssm_lib.ssm_spec(cfg, dtype), device)
        else:
            raise ValueError(kind)
        if kind != "ssm":
            self.ln2 = init_rms(cfg.d_model, device)
            self.ffn = Params(moe_lib.moe_spec(cfg, dtype) if use_moe else
                              mlp_spec(cfg.d_model, cfg.d_ff, dtype), device)

    def init(self, generator) -> None:
        self.mixer.init(generator)
        if self.kind != "ssm":
            self.ffn.init(generator)

    def _ffn(self, x):
        """(x + FFN(ln2(x)), the MoE's aux loss or ``None``)."""
        if self.kind == "ssm":
            return x, None
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.use_moe:
            h, aux = moe_lib.moe_ffn(self.ffn, self.cfg, h)
            return x + h, aux
        return x + swiglu(self.ffn, h), None

    def mix(self, x: torch.Tensor, positions: torch.Tensor):
        """``x`` + the mixer on ``ln1(x)``: the block's first half."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.mla:
            h = mla_lib.mla_attention(self.mixer, cfg, h, positions)
        elif self.kind in ATTENTION:
            h = attn.attention(self.mixer, cfg, h, positions, self.kind)
        elif self.kind == "rglru":
            h = rglru_lib.rglru_block(self.mixer, cfg, h)
        else:
            h = ssm_lib.ssm_block(self.mixer, cfg, h)
        return x + h

    def with_aux(self, x: torch.Tensor, positions: torch.Tensor):
        """Training-path block (the reference's ``apply_block``) →
        (x, aux loss float32: the MoE's, else zero)."""
        x, aux = self._ffn(self.mix(x, positions))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return shard_act(x, ("batch", "seq", "embed")), aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """The training-path block's output alone (its aux dropped)."""
        return self._ffn(self.mix(x, positions))[0]

    def init_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        """``{"k", "v"}`` for GQA attention, ``{"ckv", "kpe"}`` for MLA,
        ``{"h", "conv"}`` for RG-LRU, ``{"state", "conv"}`` for SSM
        (states in f32)."""
        if self.mla:
            return mla_lib.init_mla_cache(self.cfg, batch, max_len, dtype,
                                          device)
        if self.kind in ATTENTION:
            return attn.init_cache(self.cfg, batch, max_len, self.kind,
                                   dtype, device)
        if self.kind == "rglru":
            return rglru_lib.init_rglru_cache(self.cfg, batch, dtype, device)
        return ssm_lib.init_ssm_cache(self.cfg, batch, dtype, device)

    def prefill(self, x, positions, cache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.mla:
            h, cache = mla_lib.mla_prefill(self.mixer, cfg, h, positions,
                                           cache)
        elif self.kind in ATTENTION:
            h, cache = attn.prefill_attention(self.mixer, cfg, h, positions,
                                              self.kind, cache)
        elif self.kind == "rglru":
            h, cache = rglru_lib.rglru_prefill(self.mixer, cfg, h, cache)
        else:
            h, cache = ssm_lib.ssm_prefill(self.mixer, cfg, h, cache)
        return self._ffn(x + h)[0], cache

    def decode(self, x, pos: int, cache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.mla:
            h, cache = mla_lib.mla_decode(self.mixer, cfg, h, pos, cache)
        elif self.kind in ATTENTION:
            h, cache = attn.decode_attention(self.mixer, cfg, h, pos,
                                             self.kind, cache)
        elif self.kind == "rglru":
            h, cache = rglru_lib.rglru_decode(self.mixer, cfg, h, cache)
        else:
            h, cache = ssm_lib.ssm_decode(self.mixer, cfg, h, cache)
        return self._ffn(x + h)[0], cache


class MTPHead(torch.nn.Module):
    """DeepSeek-V3's multi-token-prediction head (``mtp_depth`` 1):
    ``proj`` (2D, D) joins the normed final state with the next token's
    embedding, ``block`` (an attention block with the stack's FFN) runs
    over the result, and ``norm`` is the RMS weight of the first half."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.proj = empty((2 * cfg.d_model, cfg.d_model), ("embed", "embed"),
                          dtype, device)
        self.block = Block(cfg, "global", dtype, device,
                           use_moe=cfg.num_experts > 0)
        self.norm = init_rms(cfg.d_model, device)

    def init(self, generator) -> None:
        self.proj = redraw(generator, self.proj)
        self.block.init(generator)


class DecoderLM(torch.nn.Module):
    """Decoder LM on ``device``.  Construction allocates the parameters
    uninitialised; fill them with :meth:`init` (random, from a generator)
    or :func:`~repro_torch.models.convert.load_reference_params`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.device = torch.device(device)
        self.kinds = tuple(cfg.pattern_layers)
        self.n_prefix = len(stack_plan(cfg)[0])
        self.embedding = empty((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), self.dtype, self.device)
        self.final_norm = init_rms(cfg.d_model, self.device)
        moe = cfg.num_experts > 0
        self.blocks = torch.nn.ModuleList(
            Block(cfg, kind, self.dtype, self.device,
                  use_moe=moe and i >= self.n_prefix)
            for i, kind in enumerate(self.kinds))
        if cfg.mtp_depth:
            self.mtp = MTPHead(cfg, self.dtype, self.device)

    # -- init ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random init from ``generator`` (a generator on the model's
        device): embedding rows truncated normal at scale 1, projections
        at fan-in scale, norms zero (identity).  Returns the model."""
        self.embedding = redraw(generator, self.embedding, scale=1.0)
        for blk in self.blocks:
            blk.init(generator)
        if self.cfg.mtp_depth:
            self.mtp.init(generator)
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
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            x, a = remat_call(self.cfg, blk.with_aux, x, positions)
            aux = aux + a
        return rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def logits(self, batch):
        h, aux = self.hidden_states(batch)
        return logits_from_tied(self.embedding, h, self.cfg.vocab_size), aux

    def loss(self, batch):
        """batch: tokens (B,S), labels (B,S) [-1 = pad] (+ patches for VLM;
        + ``labels_mtp`` for the MTP head).

        Returns (loss, metrics-dict).  VLM: labels cover text positions
        only; patch positions are prepended and excluded.  With an MTP
        head and ``labels_mtp`` the loss adds ``mtp_weight · ce_mtp``: the
        head's block runs over ``proj`` of the normed final state joined
        with the embedding of token t+1 (the main label), and its
        (un-normed) output goes through the tied head; its aux is
        dropped, as the reference drops it."""
        cfg = self.cfg
        h, aux = self.hidden_states(batch)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if cfg.num_patches and "patches" in batch:
            h = h[:, -labels.shape[1]:]
        logits = logits_from_tied(self.embedding, h, cfg.vocab_size)
        ce = cross_entropy(logits, labels)
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth and "labels_mtp" in batch:
            mtp = self.mtp
            emb_next = embed(self.embedding, labels.clamp(min=0).long())
            hin = torch.cat([rms_norm(h, mtp.norm, cfg.norm_eps),
                             emb_next.to(h.dtype)], dim=-1) @ mtp.proj
            positions = torch.arange(hin.shape[1], device=self.device)
            h_mtp = mtp.block(hin, positions.expand(hin.shape[0], -1))
            ce_mtp = cross_entropy(
                logits_from_tied(self.embedding, h_mtp, cfg.vocab_size),
                torch.as_tensor(batch["labels_mtp"], device=self.device))
            total = total + cfg.mtp_weight * ce_mtp
            metrics["ce_mtp"] = ce_mtp
        metrics["loss"] = total
        return total, metrics

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
        (B, heads, S, S) float32, or ``None`` for an attention-free stack
        and for an MLA stack (as the reference: its masks are the
        router's, :meth:`router_probs`)."""
        cfg = self.cfg
        layers = [i for i, k in enumerate(self.kinds) if k in ATTENTION]
        if not layers or cfg.attention == "mla":
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

    @torch.no_grad()
    def router_probs(self, batch):
        """The *last MoE layer's* router probabilities, (B, S, E) float32,
        for expert-utilisation masks (``saliency.expert_utilization_map``):
        the blocks before it run, then its mixer and ``ln2``, then the
        routing of ``moe.router_probs``.  ``None`` for a stack without
        MoE layers."""
        layers = [i for i, blk in enumerate(self.blocks) if blk.use_moe]
        if not layers:
            return None
        x, positions = self._inputs(batch)
        last = layers[-1]
        for blk in self.blocks[:last]:
            x = blk(x, positions)
        blk = self.blocks[last]
        x = blk.mix(x, positions)
        return moe_lib.router_probs(blk.ffn, rms_norm(x, blk.ln2,
                                                      self.cfg.norm_eps))

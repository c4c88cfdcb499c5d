"""Encoder–decoder LM (the Whisper-large-v3 backbone) on PyTorch.

The port of the JAX package's ``models/encdec.py``.  The conv frontend is
a stub, as in the reference: the batch carries precomputed frame
embeddings ``audio_feats (B, S_enc, d_model)`` (what whisper's two
stride-2 convs would emit).  Positions are absolute sinusoidal (no RoPE).

Encoder: bidirectional MHA + GELU-MLP blocks, then ``enc_norm``.
Decoder: causal self-attention (+ cache) → cross-attention over the
encoder states → GELU MLP, then ``dec_norm``.  The decoder's self-KV is
capped at ``cfg.max_decode_len`` (448) tokens; the cross-KV holds every
encoder frame.

Two behaviours of the reference are kept on purpose (ROADMAP §3):
``decode_step`` reads the position embedding of ``min(pos, 447)`` (the
reference's ``dynamic_slice_in_dim`` clamps), and ``cross_attention_maps``
projects the *final, normed* decoder state through the last block's
``ln_x``.
"""

from __future__ import annotations

import torch

from . import attention as attn
from .layers import (DTYPES, Params, cross_entropy, embed, empty, gelu_mlp,
                     init_rms, logits_from_tied, mlp_spec, redraw, remat_call,
                     rms_norm, shard_act, sinusoidal_positions)


def _mlp(cfg, dtype, device) -> Params:
    return Params(mlp_spec(cfg.d_model, cfg.d_ff, dtype, ("up", "down")),
                  device)


class EncBlock(torch.nn.Module):
    """``ln1`` → bidirectional ``attn`` → residual, ``ln2`` → ``mlp``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = init_rms(cfg.d_model, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.ln2 = init_rms(cfg.d_model, device)
        self.mlp = _mlp(cfg, dtype, device)

    def init(self, generator) -> None:
        self.attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions):
        cfg = self.cfg
        x = x + attn.bidirectional_attention(
            self.attn, cfg, rms_norm(x, self.ln1, cfg.norm_eps), positions)
        x = x + gelu_mlp(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps))
        return shard_act(x, ("batch", "seq", "embed"))


class DecBlock(torch.nn.Module):
    """``ln1`` → causal ``self`` → residual, ``ln_x`` → ``cross`` over the
    encoder states → residual, ``ln2`` → ``mlp`` → residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = init_rms(cfg.d_model, device)
        self.add_module("self", attn.Attention(cfg, dtype, device))
        self.ln_x = init_rms(cfg.d_model, device)
        self.cross = attn.Attention(cfg, dtype, device)
        self.ln2 = init_rms(cfg.d_model, device)
        self.mlp = _mlp(cfg, dtype, device)

    @property
    def self_attn(self) -> attn.Attention:
        return self._modules["self"]

    def init(self, generator) -> None:
        self.self_attn.init(generator)
        self.cross.init(generator)
        self.mlp.init(generator)

    def _rest(self, x, kv):
        """Cross-attention over ``kv`` and the MLP, each with its residual."""
        cfg = self.cfg
        x = x + attn.cross_attention(
            self.cross, cfg, rms_norm(x, self.ln_x, cfg.norm_eps), kv)
        return x + gelu_mlp(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps))

    def forward(self, x, positions, enc_out):
        cfg = self.cfg
        x = x + attn.attention(self.self_attn, cfg,
                               rms_norm(x, self.ln1, cfg.norm_eps),
                               positions, "global")
        x = self._rest(x, attn.cross_kv(self.cross, enc_out))
        return shard_act(x, ("batch", "seq", "embed"))

    def prefill(self, x, positions, enc_out, cache):
        cfg = self.cfg
        sa, sc = attn.prefill_attention(
            self.self_attn, cfg, rms_norm(x, self.ln1, cfg.norm_eps),
            positions, "global", {"k": cache["k"], "v": cache["v"]})
        kv = attn.cross_kv(self.cross, enc_out)
        return self._rest(x + sa, kv), {"k": sc["k"], "v": sc["v"],
                                        "xk": kv["k"], "xv": kv["v"]}

    def decode(self, x, pos: int, cache):
        cfg = self.cfg
        sa, sc = attn.decode_attention(
            self.self_attn, cfg, rms_norm(x, self.ln1, cfg.norm_eps), pos,
            "global", {"k": cache["k"], "v": cache["v"]})
        x = self._rest(x + sa, {"k": cache["xk"], "v": cache["xv"]})
        return x, {"k": sc["k"], "v": sc["v"], "xk": cache["xk"],
                   "xv": cache["xv"]}


class EncDecLM(torch.nn.Module):
    """Encoder–decoder LM on ``device``.  Construction allocates the
    parameters uninitialised; fill them with :meth:`init` or
    :func:`~repro_torch.models.convert.load_reference_params`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.device = torch.device(device)
        self.embedding = empty((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), self.dtype, self.device)
        self.enc = torch.nn.ModuleList(
            EncBlock(cfg, self.dtype, self.device)
            for _ in range(cfg.enc_layers))
        self.dec = torch.nn.ModuleList(
            DecBlock(cfg, self.dtype, self.device)
            for _ in range(cfg.dec_layers))
        self.enc_norm = init_rms(cfg.d_model, self.device)
        self.dec_norm = init_rms(cfg.d_model, self.device)
        self._pe_tables: dict = {}          # length → sinusoidal table

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random init from ``generator`` (on the model's device):
        embedding rows at scale 1, projections at fan-in scale, norms
        zero.  Returns the model."""
        self.embedding = redraw(generator, self.embedding, scale=1.0)
        for blk in (*self.enc, *self.dec):
            blk.init(generator)
        return self

    def _pe(self, length: int) -> torch.Tensor:
        """The (length, D) sinusoidal table in the compute dtype, made on
        the host once per length."""
        if length not in self._pe_tables:
            self._pe_tables[length] = torch.as_tensor(
                sinusoidal_positions(length, self.cfg.d_model),
                device=self.device).to(self.dtype)
        return self._pe_tables[length]

    def _positions(self, x):
        return torch.arange(x.shape[1], device=self.device).expand(
            x.shape[0], -1)

    # -- encoder -------------------------------------------------------------

    def encode(self, audio_feats) -> torch.Tensor:
        x = torch.as_tensor(audio_feats, device=self.device).to(self.dtype)
        x = x + self._pe(x.shape[1])[None]
        positions = self._positions(x)
        for blk in self.enc:
            x = remat_call(self.cfg, blk, x, positions)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    # -- decoder (train) -------------------------------------------------------

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed(self.embedding, tokens)

    def _decoder(self, tokens, enc_out) -> torch.Tensor:
        x = self._embed(tokens)
        x = x + self._pe(x.shape[1])[None]
        positions = self._positions(x)
        for blk in self.dec:
            x = remat_call(self.cfg, blk, x, positions, enc_out)
        return rms_norm(x, self.dec_norm, self.cfg.norm_eps)

    def loss(self, batch):
        """batch: audio_feats (B,S_enc,D), tokens (B,S_dec), labels
        (B,S_dec) [−1 = pad] → (loss, metrics-dict)."""
        enc_out = self.encode(batch["audio_feats"])
        h = self._decoder(batch["tokens"], enc_out)
        logits = logits_from_tied(self.embedding, h, self.cfg.vocab_size)
        ce = cross_entropy(logits, torch.as_tensor(batch["labels"],
                                                   device=self.device))
        return ce, {"ce": ce, "loss": ce}

    # -- serving ----------------------------------------------------------------

    def init_cache(self, batch: int, enc_len: int) -> list:
        """Per decoder layer: self ``k``/``v`` of ``cfg.max_decode_len``
        slots and cross ``xk``/``xv`` of ``enc_len`` frames, zeroed."""
        cfg = self.cfg

        def zeros(length):
            return torch.zeros((batch, length, cfg.num_kv_heads,
                                cfg.head_dim), dtype=self.dtype,
                               device=self.device)
        return [{"k": zeros(cfg.max_decode_len),
                 "v": zeros(cfg.max_decode_len),
                 "xk": zeros(enc_len), "xv": zeros(enc_len)}
                for _ in self.dec]

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Encode the audio and consume the decoder prompt, filling the
        self and cross caches; → (last-position logits (B,1,V), cache)."""
        enc_out = self.encode(batch["audio_feats"])
        x = self._embed(batch["tokens"])
        x = x + self._pe(x.shape[1])[None]
        positions = self._positions(x)
        for i, blk in enumerate(self.dec):
            x, cache[i] = blk.prefill(x, positions, enc_out, cache[i])
        h = rms_norm(x[:, -1:], self.dec_norm, self.cfg.norm_eps)
        return logits_from_tied(self.embedding, h, self.cfg.vocab_size), cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One token for the whole batch at absolute position ``pos``.  The
        position embedding is row ``min(pos, max_decode_len − 1)``, as the
        reference's clamped slice reads it."""
        cfg = self.cfg
        pos = int(pos)
        row = min(max(pos, 0), cfg.max_decode_len - 1)
        x = self._embed(token) + self._pe(cfg.max_decode_len)[row][None, None]
        for i, blk in enumerate(self.dec):
            x, cache[i] = blk.decode(x, pos, cache[i])
        h = rms_norm(x, self.dec_norm, cfg.norm_eps)
        return logits_from_tied(self.embedding, h, cfg.vocab_size), cache

    # -- mask extraction (MaskSearch integration) ------------------------------

    @torch.no_grad()
    def cross_attention_maps(self, batch) -> torch.Tensor:
        """(B, heads, S_dec, S_enc) float32 cross-attention of the last
        decoder block — whisper's mask source.  As the reference, its
        queries come from the *final, normed* decoder state passed through
        the last block's ``ln_x``."""
        cfg = self.cfg
        enc_out = self.encode(batch["audio_feats"])
        h = self._decoder(batch["tokens"], enc_out)
        blk = self.dec[-1]
        q = attn._proj(rms_norm(h, blk.ln_x, cfg.norm_eps), blk.cross.wq)
        k = attn._proj(enc_out, blk.cross.wk)
        return torch.softmax(attn.map_scores(q, k), dim=-1)

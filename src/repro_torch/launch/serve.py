"""Serving CLI: prefill + batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \
        [--smoke] [--device cuda] --batch 4 --prompt-len 16 --gen 32

The port of the JAX package's ``launch/serve.py``: the same prompt (numpy
seed 0), random weights from ``torch.Generator`` seed 0, one prefill and
``gen − 1`` greedy decode steps, in eager PyTorch on ``--device``.  Full
width unless ``--smoke``.  An encoder-decoder (whisper) gets 64 frames of
``audio_feats`` before its token prompt, as the reference's CLI gives it;
its self-KV holds ``cfg.max_decode_len`` (448) tokens, so keep prompt +
gen within that (past it, decode reuses the last slot and position, as
the reference does).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, load_arch, load_smoke
from ..models import build_model
from ..models.layers import count_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int = 0,
                 enc_len: int = 64) -> dict:
    """The reference CLI's prompt: uniform token ids (+ patches for a VLM;
    first ``enc_len`` frames of normal ``audio_feats`` for an
    encoder-decoder) from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["audio_feats"] = rng.standard_normal(
            (batch, enc_len, cfg.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (batch, prompt_len)).astype(np.int32)
    if cfg.num_patches:
        out["patches"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def greedy_generate(model, batch: dict, gen: int) -> dict:
    """Prefill ``batch``'s prompt, then ``gen − 1`` greedy decode steps.

    Returns ``tokens`` ((B, gen) int64 on the model's device: the prefill's
    argmax, then each step's), ``prefill_s`` and ``decode_s`` (host seconds,
    each ending in a device synchronize) and ``finite`` (every logit of
    every step was finite)."""
    cfg, dev = model.cfg, model.device
    b, prompt_len = np.shape(batch["tokens"])
    if cfg.is_encoder_decoder:
        cache = model.init_cache(b, enc_len=np.shape(batch["audio_feats"])[1])
    else:
        cache = model.init_cache(b, prompt_len + gen)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, cache)
    token = logits[:, -1:].argmax(-1)
    finite = torch.isfinite(logits).all()
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    pos0 = prompt_len + (cfg.num_patches or 0)
    out = [token]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, token, pos0 + i)
        token = logits[:, -1:].argmax(-1)
        finite &= torch.isfinite(logits).all()
        out.append(token)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0, "finite": bool(finite)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = load_smoke(args.arch) if args.smoke else load_arch(args.arch)
    dev = torch.device(args.device)
    model = build_model(cfg, dev).init(
        torch.Generator(dev).manual_seed(0))
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name} on {where}: {count_params(model):,} parameters "
          f"({cfg.dtype})")
    out = greedy_generate(model, prompt_batch(cfg, args.batch,
                                              args.prompt_len), args.gen)
    if not out["finite"]:
        raise SystemExit("serve: non-finite logits")
    steps = args.gen - 1
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{out['prefill_s'] * 1e3:.1f} ms")
    print(f"decoded {steps} steps x{args.batch} in "
          f"{out['decode_s'] * 1e3:.1f} ms "
          f"({steps * args.batch / max(out['decode_s'], 1e-9):.0f} tok/s)")
    print("sample:", out["tokens"][0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

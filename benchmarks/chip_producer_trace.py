#!/usr/bin/env python3
"""Where the mask producer's time goes on one GPU: a profiler trace.

    python3 benchmarks/chip_producer_trace.py [--arch ARCH]

With no ``--arch`` (or ``granite_3_2b``) it builds granite-3.0-2B at full width (random weights, ``torch.Generator``
seed 0, bf16) as ``chip_smoke.py``'s producer phase does, warms up, then
traces with ``torch.profiler`` (CPU and CUDA activities): the 8 x 128
prefill and 8 greedy decode steps of ``launch/serve.py``'s path, one
64-row batch of the harvest (``attention_maps`` then
``last_layer_attention`` at 224 tokens), and one full-width train step
as ``chip_smoke.py``'s phase 11 takes it (``wq``/``wk`` at 1/8 of the
init scale, 4 x 4,096 tokens in 2 microbatches, AdamW with fp32 master
weights; one untraced step first).
For each window it prints the
host wall time, the device's busy time (the union of the kernels'
intervals on the timeline) and so its idle share, the kernel count, and
the kernels that take the most device time; and the card's name and
power limit.  With ``--arch recurrentgemma_2b``, ``mamba2_13b`` or
``whisper_large_v3`` it builds that model at full width the same way and
traces what ``chip_smoke.py``'s phase 12 runs: 8 greedy decode steps
after phase 12's prefill (8 x 128 tokens; whisper 8 x 1,500 frames and 16
tokens) and one harvest batch of the family's mask source (64 x 224
tokens of attention maps or input saliency; 16 whisper cross-attention
maps of 448 tokens x 1,500 frames).  With ``--arch deepseek_v2_236b`` it
builds deepseek-v2-236b at full width cut to ``chip_smoke.py``'s 8 layers
(1 dense + 7 MoE) and traces what phase 13 runs: 8 greedy decode steps
after the 8 x 128 prefill and one harvest batch of 32 expert-utilisation
masks (224 tokens, layer 7's router).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
OTHER_ARCHS = ("recurrentgemma_2b", "mamba2_13b", "whisper_large_v3",
               "deepseek_v2_236b")


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3                      # µs → ms


def trace(torch, label, fn, smi) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    if not kernels:
        print(f"trace {label}: host wall {wall:.3f} ms; the trace holds no "
              f"device events, so device busy time is not measured ({smi})")
        return
    busy = busy_ms(kernels)
    print(f"trace {label}: host wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{len(kernels)} device ops ({smi})")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=10)
    print(table)


def trace_other(torch, arch, smi) -> None:
    """Phase 12's (deepseek: phase 13's) serve and harvest paths of
    ``arch`` at full width: 8 decode steps, then one harvest batch."""
    import dataclasses
    import chip_smoke
    from repro_torch.configs import load_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    cfg = load_arch(arch)
    if arch == chip_smoke.DEEPSEEK_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=chip_smoke.DEEPSEEK_LAYERS)
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    model.requires_grad_(False)
    prompt = chip_smoke.other_prompt(serve, cfg)
    serve.greedy_generate(model, prompt, 3)                  # warm-up
    b, p_len = prompt["tokens"].shape
    cache = (model.init_cache(b, enc_len=prompt["audio_feats"].shape[1])
             if cfg.is_encoder_decoder else model.init_cache(b, p_len + 16))
    logits, cache = model.prefill(prompt, cache)
    token = logits[:, -1:].argmax(-1)

    def decode():
        nonlocal cache, token
        for i in range(8):
            logits, cache = model.decode_step(cache, token, p_len + i)
            token = logits[:, -1:].argmax(-1)
    decode()                                                 # warm-up
    trace(torch, f"{cfg.name} decode (8 steps x{b})", decode, smi)
    del cache, logits, token
    torch.cuda.empty_cache()

    if arch == chip_smoke.DEEPSEEK_ARCH:
        one = chip_smoke.EXPERT_BATCH

        def harvest():
            return chip_smoke.expert_harvest(torch, model, dev, one)
    else:
        one = chip_smoke.OTHER_BATCH[arch]

        def harvest():
            return chip_smoke.other_harvest(torch, model, cfg, arch, dev, one)
    harvest()                                                # warm-up
    what = []
    trace(torch, f"{cfg.name} harvest batch ({one} masks)",
          lambda: what.append(harvest()[2]), smi)
    print(f"{cfg.name} harvest batch: {what[0]}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b",
                    choices=("granite_3_2b",) + OTHER_ARCHS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_producer_trace: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import load_arch
    from repro_torch.core import saliency
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.arch != "granite_3_2b":
        trace_other(torch, args.arch, smi)
        return 0
    dev = torch.device("cuda")
    cfg = load_arch("granite_3_2b")
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    prompt = serve.prompt_batch(cfg, 8, 128)
    tokens = SyntheticLMData(cfg, 224, 64, seed=0).batch_at(0)
    serve.greedy_generate(model, prompt, 3)                  # warm-up
    saliency.last_layer_attention(model.attention_maps(tokens))
    trace(torch, "serve (prefill 8x128 + 8 decode steps)",
          lambda: serve.greedy_generate(model, prompt, 9), smi)
    cache = model.init_cache(8, 160)
    logits, cache = model.prefill(prompt, cache)
    token = logits[:, -1:].argmax(-1)

    def decode():
        nonlocal cache, token
        for i in range(8):
            logits, cache = model.decode_step(cache, token, 128 + i)
            token = logits[:, -1:].argmax(-1)
    trace(torch, "decode (8 steps x8)", decode, smi)
    trace(torch, "harvest batch (64 x 224 tokens)",
          lambda: saliency.last_layer_attention(
              model.attention_maps(tokens)), smi)

    del cache, logits, token
    torch.cuda.empty_cache()
    with torch.no_grad():           # as phase 11: the grad norm stays finite
        for blk in model.blocks:
            blk.mixer.wq.mul_(0.125)
            blk.mixer.wk.mul_(0.125)
    opt_cfg = OptConfig(warmup_steps=0, total_steps=3)
    opt = init_opt_state(model.parameters(), opt_cfg)
    step = make_train_step(model, opt_cfg, microbatches=2)
    data = SyntheticLMData(cfg, 4096, 4, seed=0)
    opt, _ = step(opt, data.batch_at(0))                      # warm-up

    def train_step():
        nonlocal opt
        opt, metrics = step(opt, data.batch_at(1))
        float(metrics["loss"])
    trace(torch, "train step (4 x 4096 tokens, 2 microbatches)", train_step,
          smi)
    print(f"train step peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

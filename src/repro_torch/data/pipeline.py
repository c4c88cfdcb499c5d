"""Data pipeline: deterministic synthetic LM batches + mask-harvest hooks.

A numpy copy of the JAX package's ``data/pipeline.py`` (it never imported
JAX): batches are bit-identical to the reference's for every config.

Production shape: host-sharded loading (each host materializes only its
``global_batch / num_hosts`` rows), bounded background prefetch (straggler
mitigation: input hiccups don't stall the collective until the buffer
drains), and an augmentation side-channel that Scenario 1 feeds query
results back into.

Synthetic text is Zipf-distributed token ids with a fixed per-step PRNG
(seed ⊕ step) — restart-reproducible, which the checkpoint tests rely on.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class SyntheticLMData:
    """Deterministic synthetic batches for a ModelConfig."""

    def __init__(self, cfg, seq_len: int, global_batch: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        assert global_batch % host_count == 0
        self.cfg = cfg
        self.seq_len = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_index = host_index

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) ^ (self.host_index << 20))
        cfg = self.cfg
        b, s = self.local_batch, self.seq_len
        # Zipf-ish marginals over the vocab
        z = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens_full = (z - 1) % cfg.vocab_size
        batch = {
            "tokens": tokens_full[:, :-1].astype(np.int32),
            "labels": tokens_full[:, 1:].astype(np.int32),
        }
        if cfg.is_encoder_decoder:
            dec = min(s, cfg.max_decode_len)
            batch = {
                "audio_feats": rng.standard_normal(
                    (b, s, cfg.d_model), dtype=np.float32),
                "tokens": batch["tokens"][:, :dec],
                "labels": batch["labels"][:, :dec],
            }
        elif cfg.num_patches:
            batch["patches"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model), dtype=np.float32)
        if cfg.mtp_depth:
            mtp = np.full_like(batch["labels"], -1)
            mtp[:, :-1] = tokens_full[:, 2:]
            batch["labels_mtp"] = mtp
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Bounded background prefetch (depth N) over any batch iterator."""

    _SENTINEL = object()

    def __init__(self, source, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._stop = threading.Event()

        def work():
            try:
                for item in source:
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        item = transform(item)
                    self._q.put(item)
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class AugmentedData:
    """Wraps a base source and mixes in query-selected augmented examples —
    the Scenario-1 feedback loop (core/augment.py produces the examples)."""

    def __init__(self, base: SyntheticLMData):
        self.base = base
        self._extra: list[dict] = []

    def add_augmented(self, batch: dict) -> None:
        self._extra.append(batch)

    def batch_at(self, step: int) -> dict:
        batch = self.base.batch_at(step)
        if self._extra:
            aug = self._extra[step % len(self._extra)]
            n = min(len(aug["tokens"]), len(batch["tokens"]) // 2)
            if n:
                for key in ("tokens", "labels"):
                    if key in aug:
                        batch[key] = batch[key].copy()
                        batch[key][:n] = aug[key][:n]
        return batch

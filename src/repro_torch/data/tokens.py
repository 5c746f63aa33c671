"""Synthetic LM data pipeline: deterministic, shardable, restartable.  The
port's copy of :mod:`repro.data.tokens` (NumPy only, so the batches are the
reference's bit for bit).

Generates Zipf-ish token streams (real corpora are Zipfian — same reason the
paper's YCSB keys are) packed into fixed [B, S] batches.  ``skip`` supports
exact resume after checkpoint restore.  Stub embeddings for the audio/vlm
frontends are generated alongside.  The batches are numpy arrays; the
training loop moves them onto its device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.models.common import ArchConfig


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    # inverse-CDF Zipf over the vocab, cheap and deterministic
    u = rng.random(n)
    ranks = np.exp(u * np.log(vocab)) - 1.0
    return np.minimum(ranks.astype(np.int64), vocab - 1).astype(np.int32)


def synthetic_batches(cfg: ArchConfig, batch: int, seq: int,
                      seed: int = 0, skip: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        toks = zipf_tokens(rng, batch * seq, cfg.vocab).reshape(batch, seq)
        out = {"tokens": toks}
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if i >= skip:
            yield out
        i += 1

"""Model registry: one API over the ported architecture families.  The port
of :mod:`repro.models.registry`.

``build(cfg, device=None)`` returns a :class:`ModelAPI` whose functions run
on ``device`` (the card unless the caller asks for the CPU):

* ``init(gen)``                      -> the model (weights drawn from ``gen``)
* ``loss(model, batch)``             -> scalar next-token loss
* ``forward(model, batch)``          -> logits [B, S, V]
* ``decode_init(model, batch, s)``   -> decode state (KV cache / recurrent)
* ``decode_step(model, state, tok)`` -> (logits, state)
* ``prefill(model, batch, s)``       -> (logits, state)   (transformer families)

``batch`` is a dict: always ``tokens`` [B, S]; plus ``frames`` [B, T, D]
(audio stub) or ``patches`` [B, P, D] (vlm stub).  Every family of the
reference is ported: ``dense``, ``moe`` and ``vlm`` (transformer), ``ssm``
(RWKV6), ``hybrid`` (Griffin) and ``audio`` (Whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import rglru, rwkv6, transformer, whisper
from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[[Any, dict], torch.Tensor]
    forward: Callable[[Any, dict], torch.Tensor]
    decode_init: Callable[[Any, dict, int], Any]
    decode_step: Callable[[Any, Any, torch.Tensor], tuple]
    prefill: Optional[Callable[[Any, dict, int], tuple]] = None


def _transformer_api(cfg: ArchConfig, dev: torch.device) -> ModelAPI:
    prefix_key = {"vlm": "patches"}.get(cfg.family)
    prefix = lambda b: b[prefix_key] if prefix_key else None
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg, dev),
        loss=lambda p, b: transformer.lm_loss(p, b["tokens"], cfg,
                                              prefix_embed=prefix(b)),
        forward=lambda p, b: transformer.forward(p, b["tokens"], cfg,
                                                 prefix_embed=prefix(b)),
        decode_init=lambda p, b, s_max: transformer.init_decode(
            cfg, b["tokens"].shape[0], s_max, dev),
        decode_step=lambda p, st, t: transformer.decode_step(p, st, t, cfg),
        prefill=lambda p, b, s_max: transformer.prefill(p, b["tokens"], cfg,
                                                        s_max))


def _rwkv_api(cfg: ArchConfig, dev: torch.device) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: rwkv6.init_rwkv(gen, cfg, dev),
        loss=lambda p, b: rwkv6.lm_loss(p, b["tokens"], cfg),
        forward=lambda p, b: rwkv6.forward(p, b["tokens"], cfg),
        decode_init=lambda p, b, s_max: rwkv6.init_state(
            cfg, b["tokens"].shape[0], dev),
        decode_step=lambda p, st, t: rwkv6.decode_step(p, st, t, cfg))


def _griffin_api(cfg: ArchConfig, dev: torch.device) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: rglru.init_griffin(gen, cfg, dev),
        loss=lambda p, b: rglru.lm_loss(p, b["tokens"], cfg),
        forward=lambda p, b: rglru.forward(p, b["tokens"], cfg),
        decode_init=lambda p, b, s_max: rglru.init_state(
            cfg, b["tokens"].shape[0], dev),
        decode_step=lambda p, st, t: rglru.decode_step(p, st, t, cfg))


def _whisper_api(cfg: ArchConfig, dev: torch.device) -> ModelAPI:
    max_pos = 33_024   # covers train_4k and decode_32k target positions
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: whisper.init_whisper(gen, cfg, max_pos, dev),
        loss=lambda p, b: whisper.loss(p, b["frames"], b["tokens"], cfg),
        forward=lambda p, b: whisper.forward(p, b["frames"], b["tokens"],
                                             cfg),
        decode_init=lambda p, b, s_max: whisper.init_decode(
            p, b["frames"], cfg, s_max),
        decode_step=lambda p, st, t: whisper.decode_step(p, st, t, cfg))


_APIS = {"dense": _transformer_api, "moe": _transformer_api,
         "vlm": _transformer_api, "ssm": _rwkv_api,
         "hybrid": _griffin_api, "audio": _whisper_api}


def build(cfg: ArchConfig, device=None) -> ModelAPI:
    if cfg.family not in _APIS:
        raise ValueError(f"unknown family: {cfg.family}")
    return _APIS[cfg.family](cfg, resolve_device(device))


def make_batch(cfg: ArchConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None, device=None) -> dict:
    """A synthetic batch of the right structure (tests/examples), drawn
    from ``gen`` (seed 0 when absent) on its device and placed on
    ``device``: tokens, plus f32 normal ``frames`` [B, n_frames, D]
    (audio) or ``patches`` [B, n_patches, D] (vlm)."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=gen.device)
    out = {"tokens": tokens.to(dev)}
    stub = {"audio": ("frames", cfg.n_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        key, n = stub
        out[key] = torch.randn((batch, n, cfg.d_model), generator=gen,
                               device=gen.device).to(dev)
    return out

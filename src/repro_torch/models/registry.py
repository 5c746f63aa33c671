"""Model registry: one API over the ported architecture families.  The port
of :mod:`repro.models.registry`.

``build(cfg, device=None)`` returns a :class:`ModelAPI` whose functions run
on ``device`` (the card unless the caller asks for the CPU):

* ``init(gen)``                      -> the model (weights drawn from ``gen``)
* ``loss(model, batch)``             -> scalar next-token loss
* ``forward(model, batch)``          -> logits [B, S, V]
* ``decode_init(model, batch, s)``   -> decode state (KV cache / recurrent)
* ``decode_step(model, state, tok)`` -> (logits, state)
* ``prefill(model, batch, s)``       -> (logits, state)   (dense family)

``batch`` is a dict holding ``tokens`` [B, S].  Ported: ``dense``
(transformer) and ``ssm`` (RWKV6).  ``moe``, ``vlm``, ``hybrid`` and
``audio`` are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, transformer
from repro_torch.models.common import ArchConfig

#: Families the port does not run yet (ROADMAP item 14).
NOT_PORTED = {
    "moe": "the MoE layers (models/moe.py)",
    "vlm": "the VLM prefix path of the transformer",
    "hybrid": "the Griffin/RG-LRU model (models/rglru.py)",
    "audio": "the Whisper encoder-decoder (models/whisper.py)",
}


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
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg, dev),
        loss=lambda p, b: transformer.lm_loss(p, b["tokens"], cfg),
        forward=lambda p, b: transformer.forward(p, b["tokens"], cfg),
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


def build(cfg: ArchConfig, device=None) -> ModelAPI:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs "
            f"{NOT_PORTED[cfg.family]}, a later slice of the port "
            "(ROADMAP item 14)")
    dev = resolve_device(device)
    if cfg.family == "dense":
        return _transformer_api(cfg, dev)
    if cfg.family == "ssm":
        return _rwkv_api(cfg, dev)
    raise ValueError(f"unknown family: {cfg.family}")


def make_batch(cfg: ArchConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None, device=None) -> dict:
    """A synthetic batch of the right structure (tests/examples): tokens
    drawn from ``gen`` (seed 0 when absent) on its device, placed on
    ``device``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=gen.device)
    return {"tokens": tokens.to(dev)}

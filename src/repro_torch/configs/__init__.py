"""Assigned architecture configs (public-literature settings).

``get(name)`` returns the exact assigned :class:`ArchConfig`;
``get_reduced(name)`` returns the CPU-smoke-sized variant of the same
family.  ``ALL_ARCHS`` preserves the assignment order.

The port's copy of :mod:`repro.configs`: the same files, building the
port's :class:`repro_torch.models.common.ArchConfig`.
"""
from __future__ import annotations

import importlib

ALL_ARCHS = [
    "llama4_scout_17b_a16e",
    "qwen2_moe_a2_7b",
    "command_r_35b",
    "deepseek_67b",
    "smollm_135m",
    "granite_3_8b",
    "rwkv6_1_6b",
    "recurrentgemma_2b",
    "whisper_medium",
    "internvl2_1b",
]

_ALIAS = {a.replace("_", "-"): a for a in ALL_ARCHS}
_ALIAS.update({
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
})


def canon(name: str) -> str:
    return _ALIAS.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.CONFIG


def get_reduced(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return mod.CONFIG.reduced()

"""Device resolution shared by the port's entry points.

Every entry point takes ``device=None``, which means the card: the port is
built to run on CUDA, and a caller that wants the CPU (the tests do) asks
for it by name.  A missing card raises instead of quietly falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev

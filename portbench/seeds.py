"""Seeds of a run's parts, derived from its ``--seed``."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (weights, traffic) from any whole
    ``seed``: the same pair always gives the same number."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)

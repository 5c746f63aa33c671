"""Pure-python oracle for the Sherman index.

Semantics of a batched phase (the SIMD adaptation documented in DESIGN.md §8):
ops within one batch are applied in *lane order* — lane i "arrives" before
lane i+1.  The oracle is a sorted mapping with exactly those semantics, used
by unit and hypothesis tests to validate every batched tree operation.
"""
from __future__ import annotations

import bisect
from typing import Iterable, Optional


class OracleIndex:
    def __init__(self) -> None:
        self._keys: list[int] = []
        self._vals: dict[int, int] = {}

    # -- write ops ---------------------------------------------------------
    def insert(self, key: int, value: int) -> None:
        """Insert or update (the paper folds updates into 'insert')."""
        if key not in self._vals:
            bisect.insort(self._keys, key)
        self._vals[key] = value

    def delete(self, key: int) -> None:
        if key in self._vals:
            del self._vals[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def insert_batch(self, keys: Iterable[int], vals: Iterable[int]) -> None:
        for k, v in zip(keys, vals):
            self.insert(int(k), int(v))

    def delete_batch(self, keys: Iterable[int]) -> None:
        for k in keys:
            self.delete(int(k))

    # -- read ops ----------------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        return self._vals.get(int(key))

    def range(self, lo: int, count: int) -> list[tuple[int, int]]:
        """First ``count`` pairs with key >= lo, in key order."""
        i = bisect.bisect_left(self._keys, lo)
        out = []
        for k in self._keys[i:i + count]:
            out.append((k, self._vals[k]))
        return out

    def __len__(self) -> int:
        return len(self._keys)

    def items(self) -> list[tuple[int, int]]:
        return [(k, self._vals[k]) for k in self._keys]

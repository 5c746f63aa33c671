"""Compile-count instrumentation, kept for the reference's interface.

The reference (:mod:`repro.workloads.jitstats`) counts XLA compilations to
pin its shape-stable jit discipline.  The port runs eagerly and compiles
nothing per shape, so :func:`count_compiles` reports ``available=False``
and ``count == -1`` — the reference's own contract for "no counter here",
under which consumers skip their assertions.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class CompileStats:
    """Compile tally; ``available=False`` means nothing was counted."""
    count: int = -1
    available: bool = False


@contextlib.contextmanager
def count_compiles():
    """Yield a :class:`CompileStats` that reports no counter."""
    yield CompileStats()

"""Named spans inside the training step, on the profiler's own clock.

While a ``torch.profiler`` runs, :func:`span` opens a profiler range of
that name, so the range lands on the clock of the device's events and a
trace reader can put each device operation, and each idle gap, down to the
innermost span open when it was launched.  With no profiler running it
returns one shared no-op object: no allocation, no dispatcher call.  There
is no setting: a running profiler is the switch.

The ranges are the profiler's function-scope ranges
(``torch._C._profiler._RecordFunctionFast``), which exist on the host's
timeline only.  ``torch.profiler.record_function`` opens a user-scope
range, which the profiler also echoes onto the device's timeline as an
annotation spanning the work launched inside it; a reader that takes
every device event for an operation would count an ``rt/step`` echo as
one operation covering the whole step.

Every name starts with :data:`PREFIX`.  Spans nest, and none changes a
value.  Besides :func:`span`:

* :func:`layer_span` is ``rt/layer`` in a layer's first forward and
  ``rt/remat_replay`` when the autograd engine runs the layer again in the
  backward (on the engine's thread);
* :func:`open_in_backward` / :func:`close_in_backward` open a span when a
  tensor's gradient is about to be computed and close it once another
  tensor has its gradient, on the autograd engine's thread;
* a ``gc.callbacks`` hook puts each collection of Python's garbage
  collector in ``rt/gc``.

This module is apart from the index's observability plane (the rest of
:mod:`repro_torch.obs`), which records netsim's simulated time.
"""
from __future__ import annotations

import contextlib
import gc

import torch
import torch.autograd.profiler as _profiler

PREFIX = "rt/"
STEP = PREFIX + "step"
FORWARD = PREFIX + "forward"
BACKWARD = PREFIX + "backward"
EMBED = PREFIX + "embed"
LAYER = PREFIX + "layer"
REMAT_REPLAY = PREFIX + "remat_replay"
HEAD = PREFIX + "head"
LOSS = PREFIX + "loss"
HEAD_LOSS_BACKWARD = PREFIX + "backward/head_loss"
MOE_ROUTE = PREFIX + "moe/route"
MOE_EXPERTS = PREFIX + "moe/experts"
MOE_SHARED = PREFIX + "moe/shared"
MOE_EXPERTS_BACKWARD = PREFIX + "backward/moe_experts"
OPTIMIZER = PREFIX + "optimizer"
GRAD_NORM = PREFIX + "grad_norm"
LOSS_READ = PREFIX + "loss_read"
CHECKPOINT = PREFIX + "checkpoint"
GC = PREFIX + "gc"

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a ``torch.profiler`` is running."""
    return _profiler._is_profiler_enabled


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    runs, else a shared no-op."""
    return _range(name) if enabled() else _OFF


def layer_span():
    """:func:`span` of ``rt/remat_replay`` inside a backward (the
    rematerialised layer run again), else of ``rt/layer``."""
    if not enabled():
        return _OFF
    return _range(REMAT_REPLAY if torch._C._current_graph_task_id() >= 0
                  else LAYER)


# spans opened by a gradient hook and closed by another, by (name, the
# backward's graph task); both hooks run on the engine's thread
_open: dict = {}


def open_in_backward(t: torch.Tensor, name: str) -> None:
    """While a profiler runs, open span ``name`` when the backward reaches
    ``t`` (before ``t``'s gradient flows on)."""
    if enabled() and t.requires_grad:
        t.register_hook(lambda g: _enter_backward(name))


def close_in_backward(t: torch.Tensor, name: str) -> None:
    """While a profiler runs, close span ``name`` (opened by
    :func:`open_in_backward` in the same backward) once ``t`` has its
    gradient."""
    if enabled() and t.requires_grad:
        t.register_hook(lambda g: _exit_backward(name))


def _enter_backward(name: str) -> None:
    key = (name, torch._C._current_graph_task_id())
    if key not in _open:
        r = _range(name)
        r.__enter__()
        _open[key] = r


def _exit_backward(name: str) -> None:
    r = _open.pop((name, torch._C._current_graph_task_id()), None)
    if r is not None:
        r.__exit__(None, None, None)


_gc_range: list = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if enabled() and not _gc_range:
            r = _range(GC)
            r.__enter__()
            _gc_range.append(r)
    elif _gc_range:
        _gc_range.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)

"""The launches of the AdamW kernels over a list of leaves, planned in
plain Python (``csrc/adamw.cu`` holds the same constants).

Each leaf is cut into chunks of :data:`CHUNK` elements, one CUDA block a
chunk; its last chunk holds the ragged rest.  A launch takes at most
:data:`MAX_LEAVES` leaves, whose pointers, element counts, first chunks
and kinds travel by value in the kernel's parameter space; a longer list
takes several launches, in order.  A leaf of no element is left out.  A
leaf's kind says its gradient's type (or that it has none), its weight's,
and whether all of its pointers are 16-byte aligned, so that a thread may
move 8 elements at a time; else every element goes alone.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

CHUNK = 1 << 16
MAX_LEAVES = 640
#: a leaf's kind, as ``csrc/adamw.cu`` reads it
GRAD_NONE, GRAD_F32, GRAD_BF16 = 0, 1, 2
PARAM_BF16 = 4
ALIGNED = 8
_GRAD = {None: GRAD_NONE, torch.float32: GRAD_F32, torch.bfloat16: GRAD_BF16}
_PARAMS = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: ``leaves`` index the caller's list; leaf ``leaves[j]``'s
    chunks are the launch's blocks ``first[j]`` to ``first[j + 1] - 1``
    (``first[-1]`` the launch's blocks); ``base`` is the launch's first
    chunk counted over every launch of the list (where the norm's
    partial sums of this launch start)."""

    leaves: list
    first: list
    base: int


def n_chunks(n: int) -> int:
    return -(-n // CHUNK)


def plan(numels, max_leaves: int = MAX_LEAVES) -> list:
    """The launches over leaves of ``numels`` elements, in order."""
    out, leaves, first, base = [], [], [0], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(leaves) == max_leaves:
            out.append(Launch(leaves, first, base))
            base += first[-1]
            leaves, first = [], [0]
        leaves.append(i)
        first.append(first[-1] + n_chunks(n))
    if leaves:
        out.append(Launch(leaves, first, base))
    return out


def blocks(launches) -> int:
    """The chunks of every launch: the norm's partial sums."""
    return launches[-1].base + launches[-1].first[-1] if launches else 0


class Table(NamedTuple):
    """A list's leaves as the kernels read them, a column each: the
    gradients', weights' and moments' addresses (0: no gradient; the
    norm's table has only the gradients), the element counts and the
    kinds.  ``keep`` holds the contiguous copies the addresses point
    into, until the launches are enqueued."""

    ptrs: list
    numels: list
    kinds: list
    keep: list


def kind(g_dtype, p_dtype, ptrs) -> int:
    """The kind of a leaf whose gradient has ``g_dtype`` (None: no
    gradient), whose weight has ``p_dtype`` (None in the norm's table) and
    whose tensors start at the addresses ``ptrs`` (0 for an absent one)."""
    k = _GRAD[g_dtype] | (PARAM_BF16 if p_dtype is torch.bfloat16 else 0)
    or_ = 0
    for x in ptrs:
        or_ |= x
    return k if or_ & 15 else k | ALIGNED


def norm_table(leaves) -> Table:
    """The norm's table of the gradients ``leaves`` (None left out), each
    checked and made contiguous (a copy where it is not)."""
    xs = [x for x in leaves if x is not None]
    if not all(x.dtype in _PARAMS for x in xs):
        raise ValueError(f"the norm's kernel takes float32 or bfloat16 "
                         f"gradients, got {sorted({str(x.dtype) for x in xs})}")
    if len({x.get_device() for x in xs}) > 1:
        raise ValueError("the gradients are on more than one device")
    keep = [x.contiguous() for x in xs if not x.is_contiguous()]
    if keep:
        copies = iter(keep)
        xs = [x if x.is_contiguous() else next(copies) for x in xs]
    ptrs = [x.data_ptr() for x in xs]
    return Table([ptrs], [x.numel() for x in xs],
                 [kind(x.dtype, None, (p,)) for x, p in zip(xs, ptrs)], keep)


def _refuse(grads, ms, vs, params):
    """Raise for the first leaf the update kernel does not take: a type,
    a shape or a device that differs from the weight's."""
    dev = params[0].get_device() if params else None
    for k, (g, m, v, p) in enumerate(zip(grads, ms, vs, params)):
        g_dtype = None if g is None else g.dtype
        if p.dtype not in _PARAMS or m.dtype != torch.float32 \
                or v.dtype != torch.float32 or g_dtype not in _GRAD:
            raise ValueError(
                f"leaf {k}: the update takes float32 or bfloat16 weights "
                f"and gradients with float32 moments, got {g_dtype}, "
                f"{p.dtype}, {m.dtype}, {v.dtype}")
        shapes = [x.shape for x in (g, m, v) if x is not None]
        if any(x != p.shape for x in shapes):
            raise ValueError(f"leaf {k}: a weight of {tuple(p.shape)} with "
                             f"gradient and moments of "
                             f"{[tuple(x) for x in shapes]}")
        if any(x.get_device() != dev for x in (g, m, v, p) if x is not None):
            raise ValueError(f"leaf {k}: its tensors are not all on the "
                             f"first weight's device")


def update_table(grads, ms, vs, params):
    """The update's table of the lists, checked.  Returns ``(table,
    copied)``: a gradient that is not contiguous (the sharded step's block
    of a dimension other than the first) is copied, and ``copied`` counts
    them; the weights and moments are updated in place, so they must be
    contiguous."""
    if not len(grads) == len(ms) == len(vs) == len(params):
        raise ValueError(f"{len(grads)} gradients, {len(ms)} and {len(vs)} "
                         f"moments for {len(params)} weights")
    _refuse(grads, ms, vs, params)
    given = [g for g in grads if g is not None]
    if not all(x.is_contiguous() for xs in (params, ms, vs) for x in xs):
        raise ValueError("the update writes the weights and moments in "
                         "place: they must be contiguous")
    keep = [g.contiguous() for g in given if not g.is_contiguous()]
    if keep:
        copies = iter(keep)
        grads = [g if g is None or g.is_contiguous() else next(copies)
                 for g in grads]
    ptrs = [[0 if g is None else g.data_ptr() for g in grads]] + [
        [x.data_ptr() for x in xs] for xs in (params, ms, vs)]
    kinds = [kind(None if g is None else g.dtype, p.dtype, (a, b, c, d))
             for g, p, a, b, c, d in zip(grads, params, *ptrs)]
    return Table(ptrs, [p.numel() for p in params], kinds, keep), len(keep)

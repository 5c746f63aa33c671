"""The weights of a run, made by the benchmark from its seed.

A configuration's ``init`` lists, in order, a glob over the weights'
paths and how those weights start: ``["layers.ln*_s", "const", 1.0]``,
``["embed", "normal", 0.02]`` (a normal draw times the number), or
``["layers.w*", "fan_in", 0]`` (a normal draw over the square root of the
part's size along that axis), with an optional fourth entry that scales
the draw (``["layers.wo", "fan_in", 0, 0.144]``).  The first match wins.  Every normal draw of
the model comes from one call of a ``torch.Generator`` on the device, in
the weights' dtype; the same seed gives the same bits, so the program and
the reference are handed the same weights.

Paths name the model's weights as its reference tree does: the fields of
its nested named tuples, joined by dots (``layers.attn.wq``); a stacked
leaf (one part a layer) is one path.
"""
from __future__ import annotations

import fnmatch
import math

import torch

from portbench.seeds import sub_seed


def tree_leaves(tree, prefix: str = "") -> list:
    """``[(path, parts)]`` of a tree of named tuples whose leaves are
    tensors or stacked leaves (an object with ``parts``, one tensor a
    layer), in the tree's field order; None fields are skipped."""
    out = []
    for name, node in zip(tree._fields, tree):
        path = f"{prefix}{name}"
        if node is None:
            continue
        if hasattr(node, "_fields"):
            out.extend(tree_leaves(node, path + "."))
        elif hasattr(node, "parts"):
            out.append((path, list(node.parts)))
        else:
            out.append((path, [node]))
    return out


def rule_for(path: str, rules: list) -> tuple:
    """(kind, value, factor) of the first rule whose glob matches."""
    for pattern, kind, value, *factor in rules:
        if fnmatch.fnmatchcase(path, pattern):
            return kind, value, (factor[0] if factor else 1.0)
    raise ValueError(f"no init rule matches the weight {path!r}")


def iter_weights(specs: list, rules: list, seed: int, device,
                 dtype=torch.bfloat16):
    """Yield ``(path, layer index, tensor)`` for ``specs``, a list of
    ``(path, part shape, parts)``, in order, each value made as its rule
    says."""
    plan = [(path, tuple(shape), n, *rule_for(path, rules))
            for path, shape, n in specs]
    total = sum(math.prod(shape) * n for _, shape, n, kind, _, _ in plan
                if kind in ("normal", "fan_in"))
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights"))
    draws = torch.randn(total, generator=gen, device=device, dtype=dtype)
    at = 0
    for path, shape, n, kind, value, factor in plan:
        for i in range(n):
            if kind == "const":
                yield path, i, torch.full(shape, value, dtype=dtype,
                                          device=device)
                continue
            if kind == "normal":
                std = value
            elif kind == "fan_in":
                std = 1.0 / math.sqrt(shape[value])
            else:
                raise ValueError(f"unknown init {kind!r} for {path!r}")
            size = math.prod(shape)
            yield path, i, draws[at:at + size].view(shape) * (std * factor)
            at += size
    del draws

"""Plain-torch versions of the leaf-search kernel's two entries:
:func:`leaf_search_ref` on gathered rows (mirrors
:mod:`repro.kernels.leaf_search.ref` line for line) and
:func:`leaf_search_pool_ref` on the pool and leaf ids.

The CPU tests run them in place of the CUDA kernel, and ``chip_smoke.py``
holds the kernel against them on the card.
"""
from __future__ import annotations

import torch


def leaf_search_ref(qkeys, keys, vals, fev, rev, fnv, rnv, free):
    eq = keys == qkeys[:, None]
    found = eq.any(dim=1)
    slot = torch.argmax(eq.to(torch.int8), dim=1)
    take = lambda a: torch.gather(a, 1, slot[:, None])[:, 0]
    node_ok = (fnv == rnv) & (free == 0)
    entry_ok = take(fev.to(torch.int32)) == take(rev.to(torch.int32))
    consistent = node_ok & (entry_ok | ~found)
    value = torch.where(found & consistent, take(vals),
                        torch.full_like(qkeys, -1, dtype=torch.int32))
    return value, found & consistent, consistent


def leaf_search_pool_ref(qkeys, leaf, keys, vals, fev, rev, fnv, rnv,
                         free_bit):
    """The pool entry's plain version: gather each lane's leaf row with
    torch indexing and search it (the composition the JAX
    ``lookup_leaves`` computes).  A leaf id is wrapped like a negative
    index and then clamped to the pool, as JAX's gather does."""
    n = keys.shape[0]
    leaf = leaf.long()
    leaf = torch.where(leaf < 0, leaf + n, leaf).clamp(0, max(n - 1, 0))
    i32 = torch.int32
    return leaf_search_ref(qkeys, keys[leaf], vals[leaf], fev[leaf],
                           rev[leaf], fnv[leaf].to(i32), rnv[leaf].to(i32),
                           free_bit[leaf].to(i32))

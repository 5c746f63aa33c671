"""Plain-torch version of the leaf-search kernel (mirrors
:mod:`repro.kernels.leaf_search.ref` line for line).

The CPU tests run it in place of the CUDA kernel, and ``chip_smoke.py``
holds the kernel against it on the card.
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

"""The plain version of the grouped products: a loop over the groups,
each a matrix product of its rows.  The CPU route, and what the kernels
are held to on the card."""
from __future__ import annotations

import torch


def bounds(ends: torch.Tensor) -> list:
    """[(start, end)] of each group on the host, from the groups' ends."""
    e = [int(v) for v in ends.tolist()]
    return list(zip([0] + e[:-1], e))


def gmm_ref(a: torch.Tensor, w: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    """a [M, K] rows sorted by group, w [G, K, N], ends [G] -> c [M, N]:
    rows of group g are ``a[rows] @ w[g]``; rows from ``ends[-1]`` on are
    0.  Each product in a's dtype, accumulated as ``torch.mm`` does."""
    c = a.new_zeros((a.shape[0], w.shape[2]))
    for g, (s, e) in enumerate(bounds(ends)):
        if e > s:
            c[s:e] = a[s:e] @ w[g]
    return c


def gmm_dw_ref(a: torch.Tensor, d: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """a [M, K], d [M, N] -> dw [G, K, N]: each group's ``a[rows]ᵀ @
    d[rows]`` (0 for an empty group)."""
    g_n = ends.shape[0]
    dw = a.new_zeros((g_n, a.shape[1], d.shape[1]))
    for g, (s, e) in enumerate(bounds(ends)):
        if e > s:
            dw[g] = a[s:e].T @ d[s:e]
    return dw

"""Gather leaf rows from the pool and search them with the leaf-search
kernel (the port of :func:`repro.kernels.leaf_search.ops.lookup_leaves`).

On a CUDA state the rows are gathered on the card and the CUDA kernel
searches them; on a CPU state the kernel's plain version does.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import TreeConfig, TreeState
from repro_torch.kernels.leaf_search.kernel import leaf_search


def lookup_leaves(cfg: TreeConfig, st: TreeState, leaf: torch.Tensor,
                  qkeys: torch.Tensor):
    """Kernel-backed equivalent of :func:`repro_torch.core.ops.leaf_lookup`
    (value masked by ``found & consistent``)."""
    i32 = torch.int32
    return leaf_search(
        qkeys.to(i32).contiguous(),
        st.keys[leaf], st.vals[leaf], st.fev[leaf], st.rev[leaf],
        st.fnv[leaf].to(i32), st.rnv[leaf].to(i32),
        st.free_bit[leaf].to(i32))

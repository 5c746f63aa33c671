"""Search the pool's leaf rows for a batch of queries (the port of
:func:`repro.kernels.leaf_search.ops.lookup_leaves`).

On a CUDA state this is one launch of the leaf-search kernel, which reads
each lane's row from the pool itself; on a CPU state the plain version
gathers the rows and searches them.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import TreeConfig, TreeState
from repro_torch.kernels.leaf_search.kernel import leaf_search_pool


def lookup_leaves(cfg: TreeConfig, st: TreeState, leaf: torch.Tensor,
                  qkeys: torch.Tensor):
    """Kernel-backed equivalent of :func:`repro_torch.core.ops.leaf_lookup`
    (value masked by ``found & consistent``); ``leaf`` and ``qkeys`` are
    int32 [B]."""
    return leaf_search_pool(qkeys, leaf, st.keys, st.vals, st.fev, st.rev,
                            st.fnv, st.rnv, st.free_bit)

"""Sherman core in PyTorch: a write-optimized distributed B+Tree on a
disaggregated node pool, adapted from RDMA one-sided verbs to batched
tensor execution."""
from repro_torch.core.api import (FG_PLUS, SHERMAN, Features, IndexCache,
                                  OracleIndex, ShermanIndex, TreeConfig)
from repro_torch.core.tree import TreeState, bulkload

__all__ = ["ShermanIndex", "TreeConfig", "TreeState", "bulkload",
           "Features", "FG_PLUS", "SHERMAN", "OracleIndex", "IndexCache"]

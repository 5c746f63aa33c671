"""Multi-CS cluster plane: an asynchronous compute-server fleet over one
disaggregated memory pool (DESIGN.md §11), the port of
:mod:`repro.cluster`.

Each :class:`ClusterNode` owns a *private* index cache and LLT view while
sharing one memory-side ``TreeState`` on the device; the :class:`Cluster`
scheduler interleaves per-CS op batches in rounds and prices every wave by
merging the fleet's RDMA verb traces into one discrete-event timeline
(:func:`repro_torch.core.verbs.merge_traces`), so cross-CS cache coherence
and GLT contention are simulated rather than assumed.
"""
from repro_torch.cluster.node import ClusterNode
from repro_torch.cluster.sched import Cluster, build_cluster, run_cluster
from repro_torch.cluster.streams import ClusterStreams

__all__ = ["Cluster", "ClusterNode", "ClusterStreams", "build_cluster",
           "run_cluster"]

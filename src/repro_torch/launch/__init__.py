"""Launch helpers of the PyTorch port.

Only the host mesh is ported so far (:mod:`repro_torch.launch.mesh`): a
``(data, model)`` grid of ``torch.distributed`` ranks, and the launcher
that starts them.  The reference's production mesh, ``train``, ``dryrun``,
``shapes`` and ``elastic`` come with the LM scaffold.
"""
from repro_torch.launch.mesh import (Mesh, MeshRanks, make_host_mesh,
                                     run_mesh, start_mesh)

__all__ = ["Mesh", "MeshRanks", "make_host_mesh", "run_mesh", "start_mesh"]

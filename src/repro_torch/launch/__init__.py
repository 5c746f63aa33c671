"""Launch helpers of the PyTorch port.

The host mesh (:mod:`repro_torch.launch.mesh`): a ``(data, model)`` grid
of ``torch.distributed`` ranks, and the launcher that starts them; and
the training launcher on one device (:mod:`repro_torch.launch.train`,
imported by name).  The reference's production mesh, sharded train step,
``dryrun``, ``shapes`` and ``elastic`` are ROADMAP items 14e–14g.
"""
from repro_torch.launch.mesh import (Mesh, MeshRanks, make_host_mesh,
                                     run_mesh, start_mesh)

__all__ = ["Mesh", "MeshRanks", "make_host_mesh", "run_mesh", "start_mesh"]

"""Launch helpers of the PyTorch port.

The host mesh (:mod:`repro_torch.launch.mesh`): a ``(data, model)`` grid
of ``torch.distributed`` ranks, the launcher that starts them, the
production mesh's shape and the H100's rates; imported by name: the
training launcher and its sharded step (:mod:`repro_torch.launch.train`),
elastic re-meshing (:mod:`~repro_torch.launch.elastic`), the shape
cells (:mod:`~repro_torch.launch.shapes`) and the dry-run planner
(:mod:`~repro_torch.launch.dryrun`).
"""
from repro_torch.launch.mesh import (Mesh, MeshRanks, make_host_mesh,
                                     run_mesh, start_mesh)

__all__ = ["Mesh", "MeshRanks", "make_host_mesh", "run_mesh", "start_mesh"]

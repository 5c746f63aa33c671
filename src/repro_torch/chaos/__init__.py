"""Chaos plane: fault injection, crash recovery, differential testing —
the port of :mod:`repro.chaos`.

Faults are declared on the workload spec (``WorkloadSpec.faults``,
:class:`repro_torch.workloads.spec.FaultEvent`) and executed by
:class:`repro_torch.chaos.runner.ChaosRunner` on the simulated picosecond
timeline; :mod:`repro_torch.chaos.faults` holds the recovery mechanisms
and the differential-harness ground truth; :mod:`repro_torch.chaos.bench`
runs the calibrate → inject → audit sweep (DESIGN.md §13).
"""
from repro_torch.chaos.faults import (abandon_repairs, oracle_replay,
                                      recovery_trace, requeue_repairs,
                                      schedule_for_horizon, tree_contents)
from repro_torch.chaos.runner import ChaosRunner
from repro_torch.chaos.bench import chaos_sweep

__all__ = [
    "ChaosRunner", "abandon_repairs", "chaos_sweep", "oracle_replay",
    "recovery_trace", "requeue_repairs", "schedule_for_horizon",
    "tree_contents",
]

"""Unified YCSB workload engine for the PyTorch port.

Declarative workload specs (:class:`WorkloadSpec`), the YCSB A-F presets
plus the paper's Table 3 mixes (:data:`PRESETS`), and one batched driver
(:func:`run_workload`) that prices any spec against any feature
configuration of :class:`repro_torch.core.ShermanIndex` and emits a
JSON-serializable :class:`RunResult` — see
``python -m repro_torch.workloads --list``.
"""
from repro_torch.workloads.engine import (DEFAULT_CFG, KEYSPACE, SYSTEMS,
                                          RunResult, build_index,
                                          live_records,
                                          run_cluster_systems,
                                          run_cluster_workload,
                                          run_open_loop_systems,
                                          run_open_loop_workload,
                                          run_systems, run_workload,
                                          write_json)
from repro_torch.workloads.keygen import (draw_keys, latest_ranks,
                                          scramble, zipf_keys, zipf_ranks)
from repro_torch.workloads.spec import (ARRIVAL_KINDS, OP_KINDS, PRESETS,
                                        TABLE3_PRESETS, YCSB_PRESETS,
                                        WorkloadSpec, get_preset)

__all__ = [
    "WorkloadSpec", "RunResult", "PRESETS", "YCSB_PRESETS",
    "TABLE3_PRESETS", "OP_KINDS", "ARRIVAL_KINDS", "SYSTEMS",
    "DEFAULT_CFG", "KEYSPACE",
    "get_preset", "build_index", "live_records", "run_workload",
    "run_systems", "run_cluster_workload", "run_cluster_systems",
    "run_open_loop_workload", "run_open_loop_systems",
    "write_json", "draw_keys", "zipf_keys", "zipf_ranks", "latest_ranks",
    "scramble",
]

"""Load-sweep driver: latency vs offered load, SLO attainment, and
max-sustainable-load per system (the serving-plane headline artifact,
``BENCH_load.json``).

The sweep self-calibrates: a closed-loop run per system measures each
system's drain capacity, offered-load points are placed as fractions of
the *weakest* system's capacity (so every system sees identical rates —
the curves are comparable) plus one point near the strongest system's
capacity, and the sojourn SLO is a fixed multiple of the worst closed
p99.  A rate is *sustained* when achieved/offered throughput stays above
:data:`SUSTAINED_MIN` — past saturation the absolute horizon outgrows
the arrival horizon and the ratio collapses, which is robust where SLO
attainment alone is noisy near the knee.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import TreeConfig
from repro_torch.workloads.engine import (DEFAULT_CFG, KEYSPACE,
                                          run_cluster_workload,
                                          run_open_loop_workload,
                                          write_json)
from repro_torch.workloads.engine import SYSTEMS as _SYSTEMS
from repro_torch.workloads.spec import get_preset

#: A rate counts as sustained while achieved/offered throughput >= this.
SUSTAINED_MIN = 0.95

#: Offered-load points as fractions of the weakest system's closed-loop
#: capacity: two comfortably stable, one near the knee, one past it.
LOAD_POINTS = (0.35, 0.6, 0.85, 1.15)


def load_sweep(preset: str = "write-intensive", *,
               arrival: str = "poisson",
               systems: Sequence[str] = ("sherman", "fg+"),
               n_clients: int = 16, cfg: Optional[TreeConfig] = None,
               load_records: int = 8_000, ops: int = 2_048,
               batch: Optional[int] = None, keyspace: int = KEYSPACE,
               seed: int = 1, points: Sequence[float] = LOAD_POINTS,
               slo_factor: float = 4.0,
               out: Optional[str] = "BENCH_load.json",
               device=None) -> dict:
    """Sweep offered load over ``systems`` and report per-rate curves.

    Returns the payload dict (also written to ``out`` unless ``None``):
    per (system, rate) a RunResult row with queueing delay separated
    from service time, plus ``capacity_mops`` (closed-loop calibration)
    and ``max_sustainable_mops`` per system.  Every fleet lives on
    ``device`` (default CUDA).
    """
    cfg = cfg or DEFAULT_CFG
    spec = get_preset(preset, load_records=load_records, ops=ops,
                      **({"batch": batch} if batch else {}))
    for name in systems:
        if name.lower() not in _SYSTEMS:
            raise KeyError(f"unknown system {name!r}; "
                           f"known: {', '.join(sorted(_SYSTEMS))}")

    # -- closed-loop calibration: drain capacity + baseline p99 --------
    capacity, base_p99 = {}, 0.0
    for name in systems:
        r = run_cluster_workload(spec, _SYSTEMS[name.lower()],
                                 n_clients=n_clients, cfg=cfg,
                                 keyspace=keyspace, seed=seed, system=name,
                                 device=device)
        capacity[name] = r.mops
        base_p99 = max(base_p99, r.p99_us)
    lo_cap = min(capacity.values())
    hi_cap = max(capacity.values())
    slo_us = slo_factor * base_p99 if base_p99 else 100.0
    # shared axis: fractions of the weakest capacity, plus points at and
    # past the strongest system's knee so saturation is actually reached
    rates = sorted({round(f * lo_cap, 9) for f in points}
                   | {round(0.85 * hi_cap, 9), round(1.15 * hi_cap, 9)})

    # -- open-loop sweep ----------------------------------------------
    results, max_sustainable = [], {name: 0.0 for name in systems}
    for rate in rates:
        for name in systems:
            open_spec = spec.replace(arrival=arrival, offered_mops=rate)
            r = run_open_loop_workload(
                open_spec, _SYSTEMS[name.lower()], n_clients=n_clients,
                cfg=cfg, keyspace=keyspace, seed=seed, system=name,
                slo_us=slo_us, device=device)
            results.append(r)
            if r.sustained_frac >= SUSTAINED_MIN:
                max_sustainable[name] = max(max_sustainable[name], rate)

    extra = dict(kind="load_sweep", arrival=arrival, n_clients=n_clients,
                 rates_mops=list(rates), capacity_mops=capacity,
                 max_sustainable_mops=max_sustainable, slo_us=slo_us,
                 sustained_min=SUSTAINED_MIN)
    if out:
        write_json(out, spec, results, extra)
    payload = {"spec": spec.to_dict(),
               "results": [r.to_dict() for r in results], **extra}
    return payload

"""The open-loop serving plane (DESIGN.md §12), ported: NumPy over the
port's cluster scheduler.

Everything before this package was **closed-loop**: a fixed op count
drained in scheduler rounds, so the reported p99 was a batch artifact.
This package adds the production operating point: arrival-process
generators on netsim's shared picosecond grid (:mod:`.arrivals`), the
per-CS admission/dispatch loop that feeds the cluster's bucketed
waves as arrivals drain (:mod:`.loop`), and the load-sweep driver that
produces latency-vs-offered-load curves, SLO attainment and
max-sustainable-load per system (:mod:`.sweep`).
"""
from repro_torch.serve.arrivals import (ARRIVAL_KINDS, bursty_arrivals,
                                        diurnal_arrivals, make_arrivals,
                                        poisson_arrivals, spliced_arrivals)
from repro_torch.serve.loop import (KIND_ORDER, materialize_ops,
                                    run_open_loop, simulate_station,
                                    station_trace)
from repro_torch.serve.sweep import load_sweep

__all__ = [
    "ARRIVAL_KINDS", "KIND_ORDER", "bursty_arrivals", "diurnal_arrivals",
    "load_sweep", "make_arrivals", "materialize_ops", "poisson_arrivals",
    "run_open_loop", "simulate_station", "station_trace",
    "spliced_arrivals",
]

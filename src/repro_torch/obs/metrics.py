"""The metrics registry: fold a recorded run into ``RunResult.obs``.

One json-safe dict per recorded run — aggregate latency attribution
(all ops and the top-K tail), per-MS busy/utilization totals, the span
conservation verdict, and the top-K forensics table itself.  This is
the shape ``BENCH_obs.json`` serializes and ci.sh gates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.forensics import (attribute_ops, attribution_totals,
                                       span_accounting)
from repro_torch.obs.recorder import Recorder


def summarize(rec: Recorder, tail_k: int = 16) -> dict:
    """Aggregate a recorder's captures (empty dict when nothing was
    recorded, so unrecorded runs serialize unchanged)."""
    if not rec.segments:
        return {}
    rows = attribute_ops(rec)
    spans = span_accounting(rec)
    tail = rows[:tail_k]
    horizon = spans["horizon_s"]
    util = [b / horizon if horizon else 0.0 for b in spans["nic_busy_s"]]
    lat = np.array([r["latency_us"] for r in rows])
    return dict(
        segments=rec.n_segments, verbs=rec.n_verbs, ops=len(rows),
        faults=len(rec.faults), tail_k=int(tail_k),
        attribution=attribution_totals(rows),
        tail_attribution=attribution_totals(tail),
        tail=tail,
        attr_residual_ps=int(max((abs(r["residual_ps"]) for r in rows),
                                 default=0)),
        p99_latency_us=float(np.percentile(lat, 99)) if lat.size else 0.0,
        horizon_s=horizon,
        nic_util=util,
        nic_busy_s=spans["nic_busy_s"],
        atomic_busy_s=spans["atomic_busy_s"],
        spans_ok=spans["ok"])

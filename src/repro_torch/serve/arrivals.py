"""Arrival-process generators for the open-loop serving plane.

Every generator emits **absolute arrival timestamps on netsim's shared
integer picosecond grid** (int64 ps, monotone non-decreasing), fully
determined by the seed.  The serving loop thins one global stream
round-robin over the compute servers, so each CS's admission queue stays
sorted and (for Poisson) remains Poisson at ``rate / n_cs``.

Three processes, matching how the load literature characterizes serving
systems (latency-vs-offered-load curves that hockey-stick at
saturation):

* :func:`poisson_arrivals` — homogeneous Poisson: iid exponential
  interarrival gaps, CV = 1.  The M/G/1 analytic tests
  (tests/test_serve_queueing.py) pin the replay against
  Pollaczek–Khinchine with this process.
* :func:`bursty_arrivals` — a 2-state MMPP: a burst state at
  ``burst_factor`` × the mean rate active ``burst_frac`` of the time,
  with exponential state sojourns.  Interarrival CV strictly above
  Poisson's — the property test's definition of "bursty".
* :func:`diurnal_arrivals` — inhomogeneous Poisson under a sinusoidal
  rate envelope (a pocket-sized diurnal trace on simulator time scales),
  generated exactly by thinning.

All three normalize to the requested *mean* rate, so offered load is
comparable across processes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.netsim import PS_PER_S
# the canonical list lives in the spec
from repro_torch.workloads.spec import ARRIVAL_KINDS

#: int64 ps overflow guard: 2^62 ps ≈ 53 days of simulated time — any
#: realizable run horizon is far below this; hitting it means the rate
#: or count was nonsensical, so fail loudly instead of wrapping.
_MAX_PS = float(np.int64(1) << 62)


def _to_ps(ts_s: np.ndarray) -> np.ndarray:
    """Snap a non-decreasing float timestamp series onto the int64 ps
    grid (monotonicity preserved: rint of a sorted series is sorted)."""
    ts = np.rint(np.asarray(ts_s, np.float64) * PS_PER_S)
    if ts.size and float(ts[-1]) >= _MAX_PS:
        raise OverflowError(
            f"arrival horizon {ts_s[-1]:.3e}s overflows the int64 ps grid")
    return ts.astype(np.int64)


def _check(rate_ops_s: float, n: int) -> None:
    if rate_ops_s <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate_ops_s}")
    if n < 0:
        raise ValueError(f"arrival count must be >= 0, got {n}")


def poisson_arrivals(rate_ops_s: float, n: int, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson: ``n`` arrivals with iid Exp(1/rate) gaps."""
    _check(rate_ops_s, n)
    if n == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    return _to_ps(np.cumsum(rng.exponential(1.0 / rate_ops_s, size=n)))


def bursty_arrivals(rate_ops_s: float, n: int, seed: int = 0, *,
                    burst_factor: float = 8.0, burst_frac: float = 0.1,
                    burst_ops: float = 64.0) -> np.ndarray:
    """2-state Markov-modulated Poisson process at mean ``rate_ops_s``.

    The burst state runs at ``burst_factor`` × the mean rate and is
    occupied ``burst_frac`` of the time; the low state's rate is set so
    the time-average equals the mean.  State sojourns are exponential —
    a mean burst emits ~``burst_ops`` arrivals.  Within a sojourn the
    conditional arrival times are uniform order statistics (exact for a
    Poisson process observed over a fixed window).
    """
    _check(rate_ops_s, n)
    if not 0.0 < burst_frac < 1.0:
        raise ValueError(f"burst_frac must be in (0,1), got {burst_frac}")
    if burst_factor <= 1.0:
        raise ValueError(f"burst_factor must be > 1, got {burst_factor}")
    if burst_factor * burst_frac >= 1.0:
        raise ValueError(
            f"burst_factor*burst_frac = {burst_factor * burst_frac:g} >= 1 "
            "leaves the low state a negative rate")
    if n == 0:
        return np.zeros(0, np.int64)
    lam_b = burst_factor * rate_ops_s
    lam_l = rate_ops_s * (1.0 - burst_factor * burst_frac) / (1.0 - burst_frac)
    dwell_b = burst_ops / lam_b
    dwell_l = dwell_b * (1.0 - burst_frac) / burst_frac
    rng = np.random.default_rng(seed)
    burst = bool(rng.random() < burst_frac)   # start at stationarity
    t, got, out = 0.0, 0, []
    while got < n:
        lam, dwell_mean = (lam_b, dwell_b) if burst else (lam_l, dwell_l)
        dwell = rng.exponential(dwell_mean)
        k = int(rng.poisson(lam * dwell))
        if k:
            pts = t + np.sort(rng.random(k)) * dwell
            take = pts[:n - got]
            out.append(take)
            got += take.size
        t += dwell
        burst = not burst
    return _to_ps(np.concatenate(out))


def diurnal_arrivals(rate_ops_s: float, n: int, seed: int = 0, *,
                     period_s: float = 5e-3,
                     peak: float = 1.8) -> np.ndarray:
    """Inhomogeneous Poisson with the sinusoidal rate envelope
    ``r(t) = rate * (1 + (peak-1) * sin(2πt/period))`` — mean rate is
    exactly ``rate_ops_s`` and the instantaneous peak/mean ratio is
    ``peak`` (require ``1 < peak <= 2`` so the trough stays
    non-negative).  Generated exactly by thinning a homogeneous Poisson
    stream at the peak rate.
    """
    _check(rate_ops_s, n)
    if not 1.0 < peak <= 2.0:
        raise ValueError(f"diurnal peak must be in (1, 2], got {peak}")
    if period_s <= 0:
        raise ValueError(f"diurnal period must be positive, got {period_s}")
    if n == 0:
        return np.zeros(0, np.int64)
    a = peak - 1.0
    lam_max = rate_ops_s * (1.0 + a)
    rng = np.random.default_rng(seed)
    t, got, out = 0.0, 0, []
    while got < n:
        chunk = max(256, int(1.5 * (n - got) * (1.0 + a)))
        ts = t + np.cumsum(rng.exponential(1.0 / lam_max, size=chunk))
        keep = rng.random(chunk) < \
            (1.0 + a * np.sin(2.0 * np.pi * ts / period_s)) / (1.0 + a)
        pts = ts[keep][:n - got]
        out.append(pts)
        got += pts.size
        t = float(ts[-1])
    return _to_ps(np.concatenate(out))


def make_arrivals(kind: str, rate_ops_s: float, n: int, *, seed: int = 0,
                  burst_factor: float = 8.0, burst_frac: float = 0.1,
                  burst_ops: float = 64.0, diurnal_period_s: float = 5e-3,
                  diurnal_peak: float = 1.8) -> np.ndarray:
    """Dispatch on the spec's ``arrival`` field.  ``"closed"`` stamps
    every op at t=0 — the degenerate open-loop run the differential test
    uses to prove the serving plane reproduces the closed-loop scheduler
    tick-for-tick."""
    if kind == "closed":
        return np.zeros(max(int(n), 0), np.int64)
    if kind == "poisson":
        return poisson_arrivals(rate_ops_s, n, seed)
    if kind == "bursty":
        return bursty_arrivals(rate_ops_s, n, seed,
                               burst_factor=burst_factor,
                               burst_frac=burst_frac, burst_ops=burst_ops)
    if kind == "diurnal":
        return diurnal_arrivals(rate_ops_s, n, seed,
                                period_s=diurnal_period_s, peak=diurnal_peak)
    raise ValueError(f"unknown arrival process {kind!r}; "
                     f"known: {', '.join(ARRIVAL_KINDS)}")


def spliced_arrivals(phases, seed: int = 0, **kw) -> np.ndarray:
    """Concatenate arrival processes back-to-back on one timeline.

    ``phases`` is a sequence of ``(kind, rate_ops_s, n)`` tuples; each
    phase's stream starts where the previous phase's last arrival
    landed, so the splice is a single monotone int64-ps series whose
    rate changes mid-stream — the open-loop face of the chaos plane's
    skew shifts and hot-key storms (a storm is a high-rate phase spliced
    between two nominal ones).  Zero-length phases contribute nothing
    but still hold their position in the per-phase seed derivation, so
    adding or emptying a phase never reseeds its neighbours.  Each phase
    draws from an independent child seed of ``seed``
    (:class:`numpy.random.SeedSequence` spawn-by-index), making the
    whole splice reproducible from ``(phases, seed)`` alone.
    """
    out, t0 = [], np.int64(0)
    for i, (kind, rate, n) in enumerate(phases):
        if int(n) == 0:
            continue
        child = int(np.random.SeedSequence(
            [int(seed), i]).generate_state(1)[0])
        ts = make_arrivals(kind, rate, int(n), seed=child, **kw) + t0
        t0 = ts[-1]
        out.append(ts)
    return np.concatenate(out) if out else np.zeros(0, np.int64)

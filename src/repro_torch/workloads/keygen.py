"""Key generators for the YCSB workload engine.

Records are identified by an insertion *rank* (0 = first record loaded);
ranks are mapped to keys with a Knuth multiplicative scramble so that hot
ranks land far apart in key space (exactly what YCSB's ScrambledZipfian
does, and what keeps skewed workloads from turning into sequential-leaf
workloads).  The scramble is a bijection on ``[0, keyspace)`` whenever
``keyspace`` is a power of two, so rank-space draws never alias.

Three distributions, matching the YCSB core generators:

* ``zipfian`` — Gray et al.'s ZipfianGenerator; rank 0 receives ~1/zeta of
  all accesses (≈6-7% at theta=0.99 over 2^20 keys).
* ``uniform`` — every live record equally likely.
* ``latest``  — zipfian over recency: the most recently inserted records
  are the hottest (YCSB-D's read pattern).
"""
from __future__ import annotations

import numpy as np

SCRAMBLE = 2_654_435_761  # odd => bijective modulo any power of two

_ZETA_CACHE: dict = {}


def zeta(n: int, theta: float) -> float:
    """zeta(n, theta) with an integral tail approximation (fast + exact
    enough for the YCSB generator)."""
    key = (n, theta)
    if key not in _ZETA_CACHE:
        head = np.sum(1.0 / np.arange(1, 10_001) ** theta) \
            if n > 10_000 else np.sum(1.0 / np.arange(1, n + 1) ** theta)
        tail = ((n ** (1 - theta) - 10_000 ** (1 - theta)) / (1 - theta)
                if n > 10_000 else 0.0)
        _ZETA_CACHE[key] = float(head + tail)
    return _ZETA_CACHE[key]


def zipf_ranks(rng, n: int, nspace: int, theta: float) -> np.ndarray:
    """YCSB ZipfianGenerator (Gray et al.), vectorized; unscrambled ranks."""
    nspace = max(int(nspace), 1)
    if theta <= 0.0:
        return rng.integers(0, nspace, size=n).astype(np.int64)
    if abs(theta - 1.0) < 1e-9:
        theta = 1.0 - 1e-6   # the Gray generator is singular at theta=1
    zetan = zeta(nspace, theta)
    zeta2 = zeta(2, theta)
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / nspace) ** (1 - theta)) / (1 - zeta2 / zetan)
    u = rng.random(n)
    uz = u * zetan
    ranks = np.where(
        uz < 1.0, 0,
        np.where(uz < 1.0 + 0.5 ** theta, 1,
                 (nspace * (eta * u - eta + 1) ** alpha).astype(np.int64)))
    return np.clip(ranks, 0, nspace - 1).astype(np.int64)


def latest_ranks(rng, n: int, nspace: int, theta: float) -> np.ndarray:
    """YCSB SkewedLatestGenerator: zipfian over recency — rank
    ``nspace-1`` (the newest record) is the hottest."""
    return np.maximum(0, nspace - 1 - zipf_ranks(rng, n, nspace, theta))


def hotspot_ranks(rng, n: int, nspace: int, hot_frac: float,
                  hot_n: int) -> np.ndarray:
    """YCSB HotspotGenerator: a ``hot_frac`` share of accesses hits a
    fixed hot set of ``hot_n`` ranks, the rest is uniform over the whole
    space.  The chaos plane's hot-key *storms* are skew shifts onto this
    distribution — far spikier than any zipfian theta, concentrating the
    fleet on a handful of leaves (DESIGN.md §13)."""
    nspace = max(int(nspace), 1)
    hot_n = max(1, min(int(hot_n), nspace))
    hot = rng.random(n) < hot_frac
    ranks = rng.integers(0, nspace, size=n).astype(np.int64)
    return np.where(hot, rng.integers(0, hot_n, size=n).astype(np.int64),
                    ranks)


def scramble(ranks: np.ndarray, keyspace: int) -> np.ndarray:
    """Map insertion ranks to keys (deterministic scatter across keyspace)."""
    return ((np.asarray(ranks, np.int64) * SCRAMBLE) % keyspace
            ).astype(np.int64)


def draw_keys(rng, n: int, *, distribution: str, theta: float,
              nspace: int, keyspace: int, hot_frac: float = 0.9,
              hot_n: int = 64) -> np.ndarray:
    """Draw ``n`` keys of live records under the given distribution."""
    if distribution == "uniform":
        ranks = rng.integers(0, max(nspace, 1), size=n).astype(np.int64)
    elif distribution == "latest":
        ranks = latest_ranks(rng, n, nspace, theta)
    elif distribution == "zipfian":
        ranks = zipf_ranks(rng, n, nspace, theta)
    elif distribution == "hotspot":
        ranks = hotspot_ranks(rng, n, nspace, hot_frac, hot_n)
    else:
        raise ValueError(f"unknown distribution: {distribution!r}")
    return scramble(ranks, keyspace)


def zipf_keys(rng, n: int, keyspace: int, theta: float) -> np.ndarray:
    """Back-compat helper (the seed benchmark API): scrambled zipfian keys
    drawn over the whole keyspace."""
    if theta <= 0.0:
        return rng.integers(0, keyspace, size=n).astype(np.int64)
    return scramble(zipf_ranks(rng, n, keyspace, theta), keyspace)

"""Per-CS key streams for the cluster plane.

Each compute server draws its own operation stream from an independent
RNG, so the fleet's accesses are genuinely uncorrelated — the property
the single-frontend lane-block model could not give.  Two partitioning
policies over the shared record-rank space:

* ``shared`` (default) — every CS draws from the *whole* live-record
  space under the spec's distribution.  Skewed workloads then send every
  CS to the same global hot records: maximal cross-CS contention, the
  paper's §5 evaluation topology.
* ``partitioned`` — DEX-style (arXiv:2405.14502) static sharding: CS *i*
  draws only from its contiguous rank shard, so each CS has a private
  hot set and cross-CS conflicts (and cache-invalidation crosstalk)
  collapse.  The contrast between the two policies is exactly DEX's
  argument that compute-side partitioning, not raw client count,
  dominates scalability.

Inserts use a CS-strided rank cursor (rank ``base + i + k·n_cs`` for
CS *i*) so concurrently inserting CSs never collide on a key; newly
inserted ranks become drawable by every CS in shared mode (YCSB
semantics) and stay out of the static shards in partitioned mode.
"""
from __future__ import annotations

import numpy as np

from repro_torch.workloads.keygen import (draw_keys, hotspot_ranks,
                                          latest_ranks, scramble,
                                          zipf_ranks)
from repro_torch.workloads.spec import WorkloadSpec


class ClusterStreams:
    """Per-CS operation/key streams over one shared record space."""

    def __init__(self, spec: WorkloadSpec, n_cs: int, *,
                 keyspace: int, partitioned: bool = False, seed: int = 1):
        self.spec = spec
        self.n_cs = int(n_cs)
        self.keyspace = int(keyspace)
        self.partitioned = bool(partitioned)
        self.rngs = [np.random.default_rng((seed, cs))
                     for cs in range(self.n_cs)]
        self.n_records = int(spec.load_records)   # live records (grows)
        self._insert_base = int(spec.load_records)
        self._inserted = [0] * self.n_cs          # per-CS insert counters
        # static DEX shards over the *loaded* ranks
        per = max(1, spec.load_records // self.n_cs)
        self._shard_lo = [min(cs * per, spec.load_records)
                          for cs in range(self.n_cs)]
        self._shard_len = [max(1, (min((cs + 1) * per, spec.load_records)
                                   - self._shard_lo[cs]))
                           for cs in range(self.n_cs)]

    def draw(self, cs: int, n: int) -> np.ndarray:
        """Draw ``n`` live-record keys for CS ``cs`` (int32)."""
        rng, spec = self.rngs[cs], self.spec
        if not self.partitioned:
            return draw_keys(rng, n, distribution=spec.distribution,
                             theta=spec.theta, nspace=self.n_records,
                             keyspace=self.keyspace, hot_frac=spec.hot_frac,
                             hot_n=spec.hot_n).astype(np.int32)
        nspace = self._shard_len[cs]
        if spec.distribution == "uniform":
            ranks = rng.integers(0, nspace, size=n).astype(np.int64)
        elif spec.distribution == "latest":
            ranks = latest_ranks(rng, n, nspace, spec.theta)
        elif spec.distribution == "hotspot":
            ranks = hotspot_ranks(rng, n, nspace, spec.hot_frac,
                                  spec.hot_n)
        else:
            ranks = zipf_ranks(rng, n, nspace, spec.theta)
        return scramble(self._shard_lo[cs] + ranks,
                        self.keyspace).astype(np.int32)

    def draw_insert(self, cs: int, n: int) -> np.ndarray:
        """Draw ``n`` brand-new record keys for CS ``cs`` (CS-strided
        insertion ranks — concurrent inserters never collide)."""
        k = self._inserted[cs]
        ranks = (self._insert_base + cs
                 + (k + np.arange(n, dtype=np.int64)) * self.n_cs)
        self._inserted[cs] += n
        if not self.partitioned:
            self.n_records = max(self.n_records, int(ranks[-1]) + 1)
        return scramble(ranks, self.keyspace).astype(np.int32)

    # -- chaos plane: mid-run skew shifts + snapshot -----------------------
    def shift_skew(self, **kw) -> None:
        """Retarget the draw distribution mid-run (the chaos plane's
        skew-shift / hot-key-storm faults).  Only the key *distribution*
        moves; op mix, RNG states and insert cursors are untouched, so
        the op stream stays deterministic across the shift."""
        self.spec = self.spec.replace(**kw)

    def export_state(self) -> dict:
        """JSON-serializable snapshot of the streams' mutable state —
        per-CS RNG states, insert cursors and the (possibly shifted)
        draw-distribution parameters."""
        return dict(
            rng_states=[rng.bit_generator.state for rng in self.rngs],
            inserted=list(self._inserted),
            n_records=self.n_records,
            distribution=self.spec.distribution,
            theta=self.spec.theta,
            hot_frac=self.spec.hot_frac,
            hot_n=self.spec.hot_n,
        )

    def import_state(self, st: dict) -> None:
        """Restore a snapshot taken by :meth:`export_state`."""
        for rng, s in zip(self.rngs, st["rng_states"]):
            rng.bit_generator.state = s
        self._inserted = [int(x) for x in st["inserted"]]
        self.n_records = int(st["n_records"])
        self.spec = self.spec.replace(
            distribution=st["distribution"], theta=st["theta"],
            hot_frac=st["hot_frac"], hot_n=int(st["hot_n"]))

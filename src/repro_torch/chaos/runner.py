"""ChaosRunner — drive a cluster workload through a fault schedule.

The PyTorch counterpart of :mod:`repro.chaos.runner`: the same draw order,
RNG use, fault handlers, recovery and snapshots, over the port's
:class:`~repro_torch.cluster.sched.Cluster`.  The tree and repair queue
stay on the device of the cluster's state (CUDA unless the caller built
the cluster on the CPU); a restore or resume builds them there, and a
memory-losing crash drops the crashed pool before the restored one is
uploaded.

A deterministic re-implementation of
:func:`repro_torch.cluster.sched.run_cluster` (same per-round draw order,
same RNG consumption) with three extra powers:

* **Fault injection** on the simulated clock: events from
  ``WorkloadSpec.faults`` fire when ``sim_time_s`` passes their ``at_s``.
  MS crashes land *mid-wave* — the next write wave runs with
  ``drain=False`` so its half-splits are stranded in the repair queue
  when the server dies; CS leave/join and skew shifts apply at round
  boundaries (they are control-plane events).
* **Crash recovery**: abandon + re-derive the repair queue, GLT
  re-initialization, optional full memory loss (restore the tree image
  from the last checkpoint and replay the redo log of executed write
  waves), all priced as recovery traffic on the shared timeline.
* **Snapshot / resume**: a periodic full-run checkpoint (tree + repair
  queue + per-CS cache images as array leaves; RNG states, counters,
  cursors as a JSON side record) from which a *fresh* runner resumes
  tick-for-tick identical — equal merged-trace digests — to the
  uninterrupted run (tests/test_torch_chaos.py).

Determinism contract: every CS draws from its stream every round even
while dead (a dead CS's clients fail over, they do not stop arriving),
so the op stream is identical across fault schedules; only *placement*
changes.  The executed write log (post-failover) is the ground truth the
differential oracle replays.

Replayed redo waves re-price the lost work (honest: the work is done
twice) but their latency/doorbell samples are excised — replay is not
client traffic.  Checkpoint writes themselves are not priced: the model
is an incremental, off-path checkpoint stream (DESIGN.md §13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.chaos import faults as F
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.cluster.sched import VAL_MASK, Cluster
from repro_torch.cluster.streams import ClusterStreams
from repro_torch.core import hocl
from repro_torch.core.tree import TreeState, state_from_numpy
from repro_torch.core.write import RepairQueue, repair_from_numpy
from repro_torch.workloads.spec import OP_KINDS, WorkloadSpec


class ChaosRunner:
    """One workload run over a :class:`Cluster`, with faults."""

    def __init__(self, cluster: Cluster, spec: WorkloadSpec, *,
                 seed: int = 1, keyspace: int = 1 << 20,
                 partitioned: bool = False,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 keep: int = 4, slo_us: Optional[float] = None):
        self.cluster = cluster
        self.spec = spec
        self.keyspace = int(keyspace)
        self.schedule = sorted(spec.faults, key=lambda e: e.at_s)
        self.streams = ClusterStreams(spec, cluster.n_cs,
                                      keyspace=keyspace,
                                      partitioned=partitioned, seed=seed)
        self.mgr = (CheckpointManager(ckpt_dir, keep=keep)
                    if ckpt_dir else None)
        self.ckpt_every = int(ckpt_every)
        self.slo_us = slo_us
        self.alive = [True] * cluster.n_cs
        self.round_no = 0
        self.done = 0
        self.op_counts = {k: 0 for k in OP_KINDS}
        self.samples: list[dict] = []      # per-round timing/ops/SLO rows
        self.fault_log: list[dict] = []    # fired events, with effects
        self.write_log: list[tuple] = []   # executed write waves (oracle)
        self._redo: list[tuple] = []       # since last checkpoint (replay)
        self._fault_i = 0
        self._pending_crash: list = []
        self._replaying = False

    # -- geometry ----------------------------------------------------------
    @property
    def total_rounds(self) -> int:
        per_round = self.cluster.per_cs * self.cluster.n_cs
        return max(1, -(-self.spec.ops // per_round))

    # -- fault firing ------------------------------------------------------
    def _log_fault(self, entry: dict) -> None:
        """Append to the fault log and, when the cluster carries an
        observability recorder, mark the event as an instant marker on
        the recorded timeline (repro_torch.obs)."""
        self.fault_log.append(entry)
        rec = self.cluster.recorder
        if rec is not None:
            rec.mark_fault(entry["kind"], entry["t_fault_s"],
                           **{k: v for k, v in entry.items()
                              if k not in ("kind", "t_fault_s")})

    def _fire_due(self) -> None:
        now = self.cluster.counters["sim_time_s"]
        while (self._fault_i < len(self.schedule)
               and self.schedule[self._fault_i].at_s <= now):
            ev = self.schedule[self._fault_i]
            self._fault_i += 1
            getattr(self, "_on_" + ev.kind)(ev, now)

    def _on_ms_crash(self, ev, now: float) -> None:
        # the crash lands inside the round's next write wave (drain=False
        # strands its half-splits); _write applies the actual effects.
        self._pending_crash.append(ev)

    def _on_cs_leave(self, ev, now: float) -> None:
        cs = int(ev.cs)
        if not self.alive[cs] or sum(self.alive) <= 1:
            self._log_fault(dict(kind="cs_leave", cs=cs,
                                 t_fault_s=now, skipped=True))
            return
        self.alive[cs] = False
        self._log_fault(dict(kind="cs_leave", cs=cs, t_fault_s=now))

    def _on_cs_join(self, ev, now: float) -> None:
        cs = int(ev.cs)
        if self.alive[cs]:
            self._log_fault(dict(kind="cs_join", cs=cs,
                                 t_fault_s=now, skipped=True))
            return
        self.alive[cs] = True
        # cold restart: the joining CS's private image is gone — its
        # first reads trigger full fills (the priced warm-up transient)
        self.cluster.nodes[cs].cache.reset()
        self._log_fault(dict(kind="cs_join", cs=cs, t_fault_s=now))

    def _on_skew_shift(self, ev, now: float) -> None:
        kw = {}
        if ev.distribution:
            kw["distribution"] = ev.distribution
        if ev.theta >= 0:
            kw["theta"] = ev.theta
        if ev.hot_frac >= 0:
            kw["hot_frac"] = ev.hot_frac
        if ev.hot_n >= 1:
            kw["hot_n"] = ev.hot_n
        self.streams.shift_skew(**kw)
        self._log_fault(dict(kind="skew_shift", t_fault_s=now, **{
            k: (float(v) if isinstance(v, float) else v)
            for k, v in kw.items()}))

    # -- crash recovery ----------------------------------------------------
    def _apply_crash(self, ev) -> None:
        cl = self.cluster
        t0 = cl.counters["sim_time_s"]
        # 1. the on-chip state is gone: strand the repair queue on a host
        #    mirror, zero the crashed server's GLT rows
        mirror = F.abandon_repairs(cl)
        abandoned = int(mirror["valid"].sum()) if mirror else 0
        cl.state = hocl.reset_glt(cl.state, ev.ms)
        # 2. downtime: the pool is a single symmetric fabric, so a dead
        #    MS stalls the fleet until restart (no per-MS routing around
        #    the failure in this model)
        restart = t0 + float(ev.down_s)
        cl.counters["sim_time_s"] = restart
        if cl.clock is not None:
            # the NIC's queued-but-unissued verbs died with the server
            cl.clock.reset_ms(int(ev.ms), restart)
        rows_ms = int(cl.state.alloc_next[int(ev.ms)])
        marks = (len(cl.latencies_write), len(cl.doorbells_write),
                 len(cl.write_bytes), len(cl.queue_write))
        replayed = 0
        if ev.lose_memory:
            if self.mgr is None or not self.mgr.steps():
                raise RuntimeError(
                    "ms_crash with lose_memory needs a checkpoint "
                    "(pass ckpt_dir to ChaosRunner)")
            # the pool is lost: free it before the restored one is uploaded
            cl.state = None
            cl.state = self._restore_tree_latest()
            # redo replay: re-run every write wave executed since the
            # checkpoint (deterministic — same batches, same state), the
            # stranded half-splits included in the last entry's drain
            self._replaying = True
            try:
                for kb, vb, isd in self._redo:
                    cl.write_wave(kb, vb, is_delete=isd)
            finally:
                self._replaying = False
            replayed = len(self._redo)
        elif mirror is not None:
            # memory survived: re-derive the stranded separators from
            # the surviving B-link structure and complete them
            F.requeue_repairs(cl, mirror)
            cl.drain_repairs()
        # replayed work is not client traffic: drop its samples
        del cl.latencies_write[marks[0]:]
        del cl.doorbells_write[marks[1]:]
        del cl.write_bytes[marks[2]:]
        del cl.queue_write[marks[3]:]
        # 3. price the restart protocol itself (GLT re-arm + survey scan
        #    or image re-population), attributed to the first alive CS
        rec_cs = self.alive.index(True)
        trace = F.recovery_trace(
            cl.cfg, int(ev.ms),
            scan_rows=0 if ev.lose_memory else rows_ms,
            restore_rows=rows_ms if ev.lose_memory else 0,
            small_bytes=cl.net.small_io_bytes)
        cl._simulate_merged([(rec_cs, trace)], "maint")
        self._log_fault(dict(
            kind="ms_crash", ms=int(ev.ms), t_fault_s=float(t0),
            t_restart_s=float(restart), down_s=float(ev.down_s),
            lose_memory=bool(ev.lose_memory),
            abandoned_repairs=abandoned, replayed_waves=replayed))

    # -- failover placement ------------------------------------------------
    def _reassign(self, arrs: list, companions: Optional[list] = None):
        """Move dead slots' batches onto alive CSs (deterministic
        round-robin by dead-slot id).  ``companions`` (values drawn for
        the same keys) moves in lockstep so key/value pairing survives
        failover."""
        if all(self.alive):
            return (arrs, companions) if companions is not None else arrs
        alive_ids = [i for i, a in enumerate(self.alive) if a]
        out = list(arrs)
        comp = list(companions) if companions is not None else None

        def fold(lst, dst, src):
            lst[dst] = (lst[src] if lst[dst] is None
                        else np.concatenate([lst[dst], lst[src]]))
            lst[src] = None
        for d, a in enumerate(self.alive):
            if a or out[d] is None:
                continue
            p = alive_ids[d % len(alive_ids)]
            fold(out, p, d)
            if comp is not None:
                fold(comp, p, d)
        return (out, comp) if comp is not None else out

    # -- the write path ----------------------------------------------------
    def _write(self, keys_by, vals_by=None, is_delete: bool = False):
        crash = bool(self._pending_crash)
        self.cluster.write_wave(keys_by, vals_by, is_delete=is_delete,
                                drain=not crash)
        entry = (keys_by, vals_by, is_delete)
        self.write_log.append(entry)
        self._redo.append(entry)
        if crash:
            while self._pending_crash:
                self._apply_crash(self._pending_crash.pop(0))

    # -- one round (mirrors run_cluster's draw order exactly) --------------
    def _run_round(self, r: int) -> None:
        self._fire_due()
        cl, streams = self.cluster, self.streams
        n_cs, per_cs = cl.n_cs, cl.per_cs
        t0 = cl.counters["sim_time_s"]
        mw, mr = len(cl.latencies_write), len(cl.latencies_read)
        counts = [self.spec.batch_counts(per_cs, salt=r * n_cs + cs)
                  for cs in range(n_cs)]

        def gather(kind, draw):
            return [draw(cs, counts[cs][kind]) if counts[cs][kind] else None
                    for cs in range(n_cs)]

        if any(c["scan"] for c in counts):
            cl.scan_wave(self._reassign(gather("scan", streams.draw)),
                         count=self.spec.scan_len,
                         max_leaves=max(4, self.spec.scan_len))
        if any(c["read"] for c in counts):
            cl.lookup_wave(self._reassign(gather("read", streams.draw)))
        if any(c["rmw"] for c in counts):
            keys = self._reassign(gather("rmw", streams.draw))
            got = cl.lookup_wave(keys)
            vals = [((g.astype(np.int64) + 1) & VAL_MASK)
                    if k is not None else None
                    for k, (g, _) in zip(keys, got)]
            self._write(keys, vals)
        if any(c["update"] for c in counts):
            keys = gather("update", streams.draw)
            vals = [streams.rngs[cs].integers(0, VAL_MASK, k.size)
                    if k is not None else None
                    for cs, k in enumerate(keys)]
            self._write(*self._reassign(keys, vals))
        if any(c["delete"] for c in counts):
            self._write(self._reassign(gather("delete", streams.draw)),
                        None, is_delete=True)
        if any(c["insert"] for c in counts):
            keys = gather("insert", streams.draw_insert)
            vals = [streams.rngs[cs].integers(0, VAL_MASK, k.size)
                    if k is not None else None
                    for cs, k in enumerate(keys)]
            self._write(*self._reassign(keys, vals))
        cl.end_round()
        while self._pending_crash:      # crash in a write-less round
            self._apply_crash(self._pending_crash.pop(0))
        # per-round sample: the recovery-time / degraded-throughput basis
        t1 = cl.counters["sim_time_s"]
        new = cl.latencies_write[mw:] + cl.latencies_read[mr:]
        lat = (np.concatenate(new) if new else np.zeros(0))
        ops = sum(sum(c.values()) for c in counts)
        viol = (int((lat * 1e6 > self.slo_us).sum())
                if self.slo_us else 0)
        self.samples.append(dict(
            r=r, t0=float(t0), t1=float(t1), ops=int(ops),
            n_lat=int(lat.size), slo_viol=viol,
            p99_us=(float(np.quantile(lat, 0.99) * 1e6)
                    if lat.size else 0.0)))
        self.done += ops
        for c in counts:
            for k in OP_KINDS:
                self.op_counts[k] += c[k]

    # -- driving -----------------------------------------------------------
    def run(self, until_round: Optional[int] = None) -> "ChaosRunner":
        stop = self.total_rounds
        if until_round is not None:
            stop = min(stop, int(until_round))
        if (self.mgr is not None and self.round_no == 0
                and not self.mgr.steps()):
            self.save_checkpoint()      # a lose_memory crash at any time
        while self.round_no < stop:     # has something to restore
            self._run_round(self.round_no)
            self.round_no += 1
            if (self.mgr is not None and self.ckpt_every
                    and self.round_no % self.ckpt_every == 0):
                self.save_checkpoint()
        return self

    # -- snapshot / resume -------------------------------------------------
    _IMG_SENTINEL = "__no_image__"

    def save_checkpoint(self) -> None:
        """Full-run snapshot at a round boundary: array leaves through the
        :class:`CheckpointManager` (validated on restore; each tensor is
        copied to the host as it is written), host scalars as the JSON
        side record.  Doubles as the crash-recovery checkpoint:
        the redo log resets here, in the original and the resumed run
        alike, so later crashes replay the same waves either way."""
        cl = self.cluster
        arrays: dict = {}
        for f, v in zip(TreeState._fields, cl.state):
            arrays[f"state/{f}"] = v
        for f, v in zip(RepairQueue._fields, cl.repair):
            arrays[f"repair/{f}"] = v
        cache_scalars, cache_img_keys = [], []
        for i, node in enumerate(cl.nodes):
            img, sc = node.cache.export_state()
            cache_scalars.append(sc)
            cache_img_keys.append(sorted(img) if img else None)
            if img:
                for k, v in img.items():
                    arrays[f"cache{i}/{k}"] = v
        extra = dict(
            array_keys=sorted(arrays),
            round_no=self.round_no, done=self.done,
            op_counts=self.op_counts,
            counters=cl.counters, repair_backlog=cl._repair_backlog,
            node_counters=[dict(n.counters) for n in cl.nodes],
            cache_scalars=cache_scalars, cache_img_keys=cache_img_keys,
            streams=self.streams.export_state(),
            alive=list(self.alive), fault_i=self._fault_i,
            fault_log=self.fault_log, samples=self.samples,
            n_digests=(len(cl.trace_log)
                       if cl.trace_log is not None else 0),
        )
        self.mgr.save(arrays, step=self.round_no, extra=extra)
        self._redo = []

    def _raw_by_key(self, step: int) -> tuple[dict, dict]:
        extra = self.mgr.restore_extra(step)
        raw = self.mgr.restore_raw(step)
        # save() flattened a dict: leaves are ordered by sorted key
        vals = [raw[n] for n in sorted(raw)]
        return dict(zip(extra["array_keys"], vals)), extra

    def _restore_tree_latest(self) -> TreeState:
        by_key, _ = self._raw_by_key(self.mgr.steps()[-1])
        return state_from_numpy(
            {f: by_key[f"state/{f}"] for f in TreeState._fields},
            device=self.cluster.device)

    def load_latest(self) -> int:
        """Resume a fresh runner (same build recipe) from the newest
        snapshot; returns the round to continue from."""
        step = self.mgr.steps()[-1]
        by_key, extra = self._raw_by_key(step)
        cl = self.cluster
        cl.state = None         # free the pool before the upload
        cl.state = state_from_numpy(
            {f: by_key[f"state/{f}"] for f in TreeState._fields},
            device=cl.device)
        cl.repair = repair_from_numpy(
            {f: by_key[f"repair/{f}"] for f in RepairQueue._fields},
            device=cl.device)
        cl._repair_backlog = int(extra["repair_backlog"])
        cl.counters = dict(extra["counters"])
        for i, node in enumerate(cl.nodes):
            keys = extra["cache_img_keys"][i]
            img = ({k: by_key[f"cache{i}/{k}"] for k in keys}
                   if keys else None)
            node.cache.import_state(img, extra["cache_scalars"][i])
            node.counters = dict(extra["node_counters"][i])
        self.streams.import_state(extra["streams"])
        self.alive = [bool(a) for a in extra["alive"]]
        self._fault_i = int(extra["fault_i"])
        self.fault_log = list(extra["fault_log"])
        self.samples = list(extra["samples"])
        self.round_no = int(extra["round_no"])
        self.done = int(extra["done"])
        self.op_counts = {k: int(v)
                          for k, v in extra["op_counts"].items()}
        self._redo = []
        return self.round_no

    # -- reporting ---------------------------------------------------------
    def report(self, recover_frac: float = 0.7,
               recover_rounds: int = 2) -> dict:
        """Recovery metrics per fired fault.

        Baseline = median per-round throughput before the first fault.
        A fault has *recovered* at the end of the first round that opens
        a run of ``recover_rounds`` consecutive rounds at or above
        ``recover_frac``×baseline; TTR and the degraded-window
        throughput/SLO-violation fraction follow from that point.
        """
        s, cl = self.samples, self.cluster
        tput = [x["ops"] / (x["t1"] - x["t0"]) if x["t1"] > x["t0"]
                else 0.0 for x in s]
        fired = [f for f in self.fault_log if not f.get("skipped")]
        first_t = min((f["t_fault_s"] for f in fired), default=None)
        pre = [tp for x, tp in zip(s, tput)
               if first_t is None or x["t1"] <= first_t]
        baseline = float(np.median(pre if pre else tput)) if s else 0.0
        rows = []
        for f in fired:
            tf = f["t_fault_s"]
            t_rec = None
            for j, x in enumerate(s):
                if x["t1"] <= tf:
                    continue
                win = tput[j:j + recover_rounds]
                if (len(win) == recover_rounds and baseline > 0
                        and all(w >= recover_frac * baseline
                                for w in win)):
                    t_rec = s[j]["t1"]
                    break
            row = dict(f)
            if t_rec is not None and t_rec > tf:
                win = [x for x in s if tf < x["t1"] <= t_rec]
                n_ops = sum(x["ops"] for x in win)
                n_lat = sum(x["n_lat"] for x in win)
                row.update(
                    t_recover_s=float(t_rec), ttr_s=float(t_rec - tf),
                    degraded_mops=n_ops / (t_rec - tf) / 1e6,
                    slo_violation_frac=(
                        sum(x["slo_viol"] for x in win) / n_lat
                        if n_lat else 0.0))
            else:
                row.update(t_recover_s=None, ttr_s=None,
                           degraded_mops=None, slo_violation_frac=None)
            rows.append(row)
        return dict(
            baseline_mops=baseline / 1e6,
            overall_mops=cl.throughput_mops(),
            done=self.done, rounds=self.round_no,
            sim_time_s=float(cl.counters["sim_time_s"]),
            conservation_ok=bool(cl.conservation_ok()),
            glt_clean=bool((cl.state.glt == 0).all()),
            unfired_faults=len(self.schedule) - self._fault_i
            + len(self._pending_crash),
            faults=rows)

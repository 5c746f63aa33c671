"""One run of one cell: set-up, the measured window, the readings, and the
comparison with the reference that decides ``correct``.

Everything a cell needs is found by name:

* ``BENCHMARK.json``: the cell (its configuration and traffic names, its
  chips) and the metrics with the cells they are read in;
* ``configs/<config>.json``: the program's registry name and overrides,
  the model's sizes as the reference reads them, the weights' init table;
* ``traffic/<traffic>.json``: the batches and the optimizer of the job;
* ``workloads/<cell>.json``: the limits of the numbers compared, with the
  readings they were set from;
* ``metrics/<metric>.py``: each per-layer metric's reader;
* ``reference/<model>.py``: the model's plain reference.

A run makes the weights and a ring of batches from its seed on the device,
builds the program's training step (``registry.build``,
``launch/train.py::make_train_step``, ``optim/adamw.py``), drives it
through the traffic's checked steps (its warm-up; the readings the
reference is held to are taken there), then runs steps back to back for
the window, reading each step's loss as ``launch/train.py::run`` does.
A traced run then runs the traffic's ``traced_steps`` more under
``torch.profiler``, after one profiled step that is left out (the
profiler's start-up), so the window's host-clock numbers are the same as
an untraced run's.  After the window the program's state is freed and the reference follows
the checked steps from the same weights and batches.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import statistics
import time
from pathlib import Path

import torch

from portbench import devtrace as tracing
from portbench.reference.common import Products, Trainer, exact_f32, follow
from portbench.traffic import loss_positions, make_ring
from portbench.weights import iter_weights, tree_leaves

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: faults a test or a calibration plants under the timed path: a step that
#: returns its state unchanged; half of each batch left out, the mean taken
#: over the rest; the step's answer, its loss, altered by 1% where
#: ``api.loss`` produces it
FAULTS = ("unchanged", "half_batch", "altered_loss")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict         # {number: limit}; empty until calibrated

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.model['reference']}")

    def specs(self) -> list:
        """``[(path, part shape, parts)]`` of the model's weights in the
        reference's order."""
        n = self.model["n_layers"]
        return [(p, s, n if p.startswith("layers.") else 1)
                for p, s in self.reference.expected_shapes(self.model).items()]

    def positions_per_row(self) -> int:
        prefix = self.model.get("prefix")
        return self.traffic["seq"] + (prefix["length"] if prefix else 0)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_bench()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits_file = HERE / "workloads" / f"{name}.json"
    limits = load_json(limits_file).get("limits", {}) \
        if limits_file.exists() else {}
    return Cell(name=name, entry=entry,
                config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" /
                                  f"{entry['traffic']}.json"),
                limits=limits)


def metric_reader(name: str):
    """The reader of metric ``name``; a name split by cells
    (``mfu.vlm``) reads with the reader of the part before its dot."""
    return importlib.import_module(
        f"portbench.metrics.{name.split('.')[0]}")


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------

def program_config(cell: Cell):
    """The program's ArchConfig for the cell, with the configuration's
    overrides, checked against the sizes the configuration states."""
    from repro_torch.configs import get
    prog = cell.config["program"]
    overrides = {k: getattr(torch, v) if k == "dtype" else v
                 for k, v in prog["overrides"].items()}
    cfg = dataclasses.replace(get(prog["registry"]), **overrides)
    want = getattr(torch, cell.config["dtype"])
    if cfg.dtype != want:
        raise ValueError(f"the program's dtype {cfg.dtype}, the "
                         f"configuration's {want}")
    for key, value in prog["agrees"].items():
        if getattr(cfg, key) != value:
            raise ValueError(f"the program's {key} is {getattr(cfg, key)!r}, "
                             f"the configuration states {value!r}")
    return cfg


class Program:
    """The program's model, optimizer state and training step for a cell,
    with the benchmark's weights copied in."""

    def __init__(self, cell: Cell, seed: int, device, traced: bool = False,
                 fault: str | None = None):
        from repro_torch.launch.train import make_train_step
        from repro_torch.models import registry
        from repro_torch.models.common import flat_params
        from repro_torch.optim import adamw
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.device = cell, seed, device
        self.fault = fault
        cfg = program_config(cell)
        # the model's structure from the program's own init, on no device
        model = registry.build(cfg, device="meta").init(None)
        self.model = model.to_empty(device=device)
        api = registry.build(cfg, device=device)
        self.leaves = dict(tree_leaves(api.param_tree(self.model)))
        specs = cell.specs()
        got = {p: (tuple(parts[0].shape), len(parts))
               for p, parts in self.leaves.items()}
        want = {p: (tuple(s), n) for p, s, n in specs}
        if got != want:
            raise ValueError(f"the program's weights {got} differ from the "
                             f"reference's {want}")
        with torch.no_grad():
            for path, i, value in iter_weights(specs, cell.config["init"],
                                               seed, device, cfg.dtype):
                self.leaves[path][i].copy_(value)
        self.params = flat_params(api.param_tree(self.model))
        self.opt_cfg = adamw.AdamWConfig(**cell.traffic["optimizer"])
        self.opt_state = adamw.init(self.params)
        if fault == "altered_loss":
            loss_fn = api.loss
            api = dataclasses.replace(api, loss=lambda m, b: loss_fn(m, b)
                                      * 1.01)
        if traced:
            loss = api.loss
            api = dataclasses.replace(api, loss=lambda m, b: _ranged(
                "forward+loss", loss, m, b))
        if fault == "unchanged":
            def step(model, opt_state, batch):
                with torch.no_grad():
                    loss = api.loss(model, batch)
                return model, opt_state, dict(loss=loss)
            self.step_fn = step
        else:
            self.step_fn = make_train_step(api, self.opt_cfg)
        self.at = 0

    def step(self, ring: list) -> float:
        """One step on the ring's next batch; the loss read back."""
        batch = ring[self.at % len(ring)]
        if self.fault == "half_batch":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        self.at += 1
        self.model, self.opt_state, metrics = self.step_fn(
            self.model, self.opt_state, batch)
        with torch.profiler.record_function("loss read"):
            return float(metrics["loss"])

    def leaf_norms(self, values: list) -> dict:
        """{path: norm} of ``values``, one tensor a parameter in
        ``params`` order, summed in float64 and read back at once."""
        of = {id(p): k for k, p in enumerate(self.params)}
        sq = torch.stack([torch.sum(values[of[id(p)]].double() ** 2)
                          for parts in self.leaves.values() for p in parts])
        return _per_leaf(self.leaves, sq)

    def checked_steps(self, ring: list) -> dict:
        """The traffic's checked steps, with the readings the reference is
        held to: each step's loss, the first gradient as the optimizer got
        it (from its first moment after one step), and each leaf's change
        over the steps."""
        losses = []
        grad = None
        b1 = self.opt_cfg.b1
        for _ in range(self.cell.traffic["checked_steps"]):
            losses.append(self.step(ring))
            if grad is None:
                m = self.leaf_norms(self.opt_state.m)
                grad = {p: v / (1 - b1) for p, v in m.items()}
        sq = {}
        with torch.no_grad():
            for path, i, w0 in iter_weights(
                    self.cell.specs(), self.cell.config["init"], self.seed,
                    self.device, self.leaves[next(iter(self.leaves))][0].dtype):
                d = self.leaves[path][i].double() - w0.double()
                sq[(path, i)] = torch.sum(d * d)
        change = _per_leaf(self.leaves, torch.stack(
            [sq[(p, i)] for p, parts in self.leaves.items()
             for i in range(len(parts))]))
        return dict(losses=losses, grad=grad, change=change)


def _per_leaf(leaves: dict, sq: torch.Tensor) -> dict:
    """{path: sqrt of the sum of its parts' entries of ``sq``}, ``sq``
    holding one sum of squares a part in ``leaves``' order."""
    sq = sq.cpu().tolist()
    out, at = {}, 0
    for path, parts in leaves.items():
        out[path] = math.sqrt(sum(sq[at:at + len(parts)]))
        at += len(parts)
    return out


def _ranged(name, fn, *args):
    with torch.profiler.record_function(name):
        return fn(*args)


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------

def reference_readings(cell: Cell, seed: int, batches: list, device,
                       precision: str = "f32") -> dict:
    """The reference's readings over ``batches`` (the checked steps'),
    from the weights the seed makes; ``precision`` "fp8" is the control."""
    exact_f32()
    model = cell.model
    ref = cell.reference
    weights: dict = {}
    dtype = getattr(torch, cell.config["dtype"])
    for path, i, value in iter_weights(cell.specs(), cell.config["init"],
                                       seed, device, dtype):
        if path.startswith("layers."):
            weights.setdefault(path, []).append(value.float())
        else:
            weights[path] = value.float()
    prod = Products(precision)
    trainer = Trainer(weights, lambda w, rows: ref.loss_sums(w, rows, model,
                                                             prod),
                      cell.traffic["optimizer"], weight_dtype=dtype,
                      rows_per_block=cell.config["reference_rows_per_block"])
    del weights
    out = follow(trainer, batches, loss_positions(cell.traffic))
    del trainer
    gc.collect()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return dict(losses=out["losses"],
                grad={p: float(v) for p, v in out["grad"].items()},
                grad_raw={p: float(v) for p, v in out["grad_raw"].items()},
                change={p: float(v) for p, v in out["change"].items()})


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap")


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers a cell may compare.  ``loss_gap``: the largest gap
    between the two sides' losses over the checked steps (nats).
    ``grad_gap``: the worst leaf's gap between the two sides' norms of the
    first gradient as the optimizer gets it, over the larger of the
    reference's norm of that leaf and of its median leaf;
    ``grad_gap_median``: the median leaf's such gap.  ``change_gap``: the
    worst leaf's gap, so measured, between the norms of the weights'
    change over the checked steps, leaving out leaves whose reference
    gradient is under a thousandth of the median leaf's (their change is
    rounding).  ``grad_leaf`` and ``change_leaf`` name the worst leaves."""
    loss = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))

    def rel(p: dict, r: dict, keys) -> list:
        keys = list(keys)
        med = statistics.median(r[k] for k in keys)
        return sorted((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k)
                      for k in keys)

    raw_med = statistics.median(ref["grad_raw"].values())
    moving = [k for k, v in ref["grad_raw"].items() if v >= 1e-3 * raw_med]
    grad = rel(prog["grad"], ref["grad"], ref["grad"])
    change = rel(prog["change"], ref["change"], moving)
    return dict(loss_gap=loss, grad_gap=grad[-1][0],
                grad_gap_median=statistics.median(g for g, _ in grad),
                change_gap=change[-1][0], grad_leaf=grad[-1][1],
                change_leaf=change[-1][1])


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number the cell compares (those its limits
    name) beside its limit; correct when there is one and each is within
    its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in NUMBERS if k in limits}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None, bench: dict | None = None,
        cell: Cell | None = None, log=lambda msg: None) -> dict:
    """One run of ``workload`` (``cell``, where given, in place of the
    files' cell of that name); ``t_start`` is the process's start on the
    ``time.perf_counter`` clock.  Returns the result's fields (``checks``
    last).  ``log`` receives a line at the end of each phase."""
    bench = bench if bench is not None else load_bench()
    cell = cell or load_cell(workload, bench)
    mark = [t_start]

    def phase(name: str) -> None:
        now = time.perf_counter()
        log(f"{name}: {now - mark[0]:.3f} s")
        mark[0] = now
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    if trace:
        from repro_torch.optim import adamw
        update = adamw.update
        adamw.update = lambda *a, **k: _ranged(
            "optimizer", lambda: update(*a, **k))
    try:
        phase("start to harness")
        ring = make_ring(cell.traffic, cell.model, seed, device)
        prog = Program(cell, seed, device, traced=trace, fault=fault)
        sync()
        phase("batches, weights, model and optimizer state")
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        readings = prog.checked_steps(ring)
        sync()
        phase(f"{cell.traffic['checked_steps']} checked steps and their "
              "readings")
        steps = failed = 0
        t0 = time.perf_counter()
        ends = []
        while True:
            loss = prog.step(ring)
            steps += 1
            failed += not math.isfinite(loss)
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
        each = sorted(b - a for a, b in zip([t0] + ends, ends))
        phase(f"window: {steps} steps, each {each[0]:.4f} to {each[-1]:.4f}"
              f" s, median {statistics.median(each):.4f} s")
        traced = 0
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_cuda else [])
            with profile(activities=acts) as prof:
                failed += not math.isfinite(prog.step(ring))
                with torch.profiler.record_function(tracing.WINDOW):
                    for _ in range(cell.traffic["traced_steps"]):
                        failed += not math.isfinite(prog.step(ring))
                        traced += 1
                    sync()
            phase(f"traced: 1 + {traced} steps")
    finally:
        if trace:
            adamw.update = update
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    window_s = t1 - t0
    tokens = loss_positions(cell.traffic)
    end_to_end = {"train_tokens_per_s": steps * tokens / window_s,
                  "peak_mem_gb": peak / 1e9, "setup_s": t0 - t_start}
    tr = tracing.read(prof) if trace else None
    prof = None
    if trace:
        phase(f"trace read: {len(tr.ops)} device operations")
    del prog
    checked = [ring[i] for i in range(cell.traffic["checked_steps"])]
    del ring
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, checked, device)
    phase("reference")
    correct, checks = judge(gaps(readings, ref), cell.limits)
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        ctx = MetricContext(cell=cell, trace=tr, steps=traced,
                            window_steps=steps, window_s=window_s)
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {
                    "value": end_to_end[m["name"].split(".")[0]],
                    "unit": units[m["name"]]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct and failed == 0,
              "attempted": steps + (1 + traced if trace else 0),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader reads: the cell, the traced
    steps' trace and their number, and the untraced window's steps and
    host-clock seconds."""
    cell: Cell
    trace: tracing.Trace
    steps: int
    window_steps: int
    window_s: float

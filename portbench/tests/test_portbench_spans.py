"""The span reader (``spantrace.py``) on synthetic profiler events and on
a traced run of a tiny cell on the CPU: device echoes of the program's
spans are dropped, nested spans resolve to the innermost one, a trace
without spans reads as ``devtrace.read`` reads it (and so does one with
the program's host-only spans), and each reading comes out as counted by
hand."""
import time
import types

import pytest
from torch.autograd import DeviceType

from portbench import devtrace, harness, spantrace
from portbench.tests.test_portbench_metrics import FakeEvent
from portbench.tests.tiny import tiny_cell

CPU, GPU = DeviceType.CPU, DeviceType.CUDA
NS = 1e-6     # ms in a ns

# the benchmark's own: its window and ranges, each with a device echo
BENCH = [FakeEvent("window", CPU, 0, 1000, 1),
         FakeEvent("window", GPU, 0, 1000, 1),
         FakeEvent("forward+loss", CPU, 100, 300, 2),
         FakeEvent("forward+loss", GPU, 120, 270, 2),
         FakeEvent("optimizer", CPU, 700, 190, 3)]
# the program's spans on the host (a step; the autograd thread's spans
# nest in time inside the caller's backward)
SPANS = [FakeEvent("rt/step", CPU, 50, 850, 0),
         FakeEvent("rt/forward", CPU, 100, 300, 0),
         FakeEvent("rt/loss", CPU, 300, 90, 0),
         FakeEvent("rt/backward", CPU, 400, 300, 0),
         FakeEvent("rt/backward/head_loss", CPU, 410, 30, 0),
         FakeEvent("rt/remat_replay", CPU, 450, 100, 0),
         FakeEvent("rt/optimizer", CPU, 700, 190, 0),
         FakeEvent("rt/loss_read", CPU, 900, 80, 0)]
# launches (runtime calls; the synchronisation enqueues nothing) and the
# device operations they enqueued
WORK = [FakeEvent("cudaLaunchKernel", CPU, 110, 1, 11),
        FakeEvent("cudaLaunchKernel", CPU, 310, 1, 12),
        FakeEvent("cudaLaunchKernel", CPU, 415, 1, 13),
        FakeEvent("cudaLaunchKernel", CPU, 460, 1, 14),
        FakeEvent("cudaMemsetAsync", CPU, 470, 1, 15),
        FakeEvent("cudaLaunchKernel", CPU, 710, 1, 16),
        FakeEvent("cudaMemcpyAsync", CPU, 905, 1, 17),
        FakeEvent("cudaStreamSynchronize", CPU, 930, 20, 18),
        FakeEvent("embed_k", GPU, 120, 30, 11),
        FakeEvent("lse_k", GPU, 320, 60, 12),
        FakeEvent("ce_bwd_k", GPU, 420, 10, 13),
        FakeEvent("replay_k", GPU, 470, 50, 14),
        FakeEvent("Memset (Device)", GPU, 520, 5, 15),
        FakeEvent("adam_k", GPU, 720, 80, 16),
        FakeEvent("Memcpy DtoH", GPU, 910, 10, 17)]
# what a user-scope range would add: its echo on the device
ECHOES = [FakeEvent("rt/step", GPU, 120, 800, 0),
          FakeEvent("rt/loss", GPU, 320, 60, 0)]


def profile_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def same_as_devtrace(events):
    base = devtrace.read(profile_of(events))
    tr = spantrace.read(profile_of(events))
    key = lambda ops: [(o.name, o.start_ns, o.end_ns, o.launched_in)
                       for o in ops]
    assert key(tr.ops) == key(base.ops)
    assert tr.ranges == base.ranges and tr.window == base.window
    return base, tr


def test_a_trace_without_spans_reads_as_before():
    base, tr = same_as_devtrace(BENCH + WORK)
    assert tr.breakdown() == base.breakdown()
    assert tr.spans == [] and tr.steps() == 0
    for read in (spantrace.head_loss_ms_per_step,
                 spantrace.remat_replay_ms_per_step,
                 spantrace.launches_per_step, spantrace.step_share,
                 spantrace.table):
        assert read(tr) is None
    # the benchmark's readers read the same values from either
    for m in harness.load_bench()["per_layer"]:
        for cell in m["workloads"]:
            ctx = lambda t: harness.MetricContext(
                cell=harness.load_cell(cell), trace=t, steps=1,
                window_steps=10, window_s=1e-5)
            reader = harness.metric_reader(m["name"])
            assert reader.read(ctx(tr)) == reader.read(ctx(base))


def test_host_spans_leave_the_benchmarks_reading_as_it_was():
    """The program's spans have no device echo (function-scope ranges):
    ``devtrace.read`` then reads the same operations with them as
    without, and ``spantrace.read`` drops an echo where there is one."""
    base, _ = same_as_devtrace(BENCH + SPANS + WORK)
    assert [o.name for o in base.ops] == [
        o.name for o in devtrace.read(profile_of(BENCH + WORK)).ops]
    tr = spantrace.read(profile_of(BENCH + SPANS + ECHOES + WORK))
    assert tr.echoes == 2
    assert [o.name for o in tr.ops] == [o.name for o in base.ops]


def test_nested_spans_resolve_to_the_innermost():
    tr = spantrace.read(profile_of(BENCH + SPANS + ECHOES + WORK))
    assert tr.innermost_span(350) == "rt/loss"
    assert tr.innermost_span(250) == "rt/forward"
    assert tr.innermost_span(460) == "rt/remat_replay"
    assert tr.innermost_span(600) == "rt/backward"
    assert tr.innermost_span(20) is None
    assert tr.stacks_at([415, 950]) == [
        ("rt/step", "rt/backward", "rt/backward/head_loss"),
        ("rt/loss_read",)]
    spans = {o.name: o.span for o in tr.ops}
    assert spans == {"embed_k": "rt/forward", "lse_k": "rt/loss",
                     "ce_bwd_k": "rt/backward/head_loss",
                     "replay_k": "rt/remat_replay",
                     "Memset (Device)": "rt/remat_replay",
                     "adam_k": "rt/optimizer",
                     "Memcpy DtoH": "rt/loss_read"}
    # gaps named by the benchmark's range and the innermost span
    gaps = dict(tr.idle_gaps())
    assert gaps["forward+loss/rt/forward"] == pytest.approx(170e-9)
    assert gaps["backward and glue/rt/step"] == pytest.approx(120e-9)
    assert gaps["optimizer/rt/optimizer"] == pytest.approx(110e-9)


def test_the_readings():
    tr = spantrace.read(profile_of(BENCH + SPANS + ECHOES + WORK))
    assert tr.steps() == 1
    # lse_k, ce_bwd_k
    assert spantrace.head_loss_ms_per_step(tr) == pytest.approx(70 * NS)
    # replay_k and its memset
    assert spantrace.remat_replay_ms_per_step(tr) == pytest.approx(55 * NS)
    # six calls inside rt/step; the loss's copy is outside it, and the
    # synchronisation enqueued nothing
    assert [n for _, n in tr.launches].count("cudaStreamSynchronize") == 0
    assert spantrace.launches_per_step(tr) == 6
    assert spantrace.step_share(tr) == pytest.approx(235 / 245)
    table = spantrace.table(tr)
    assert table["rt/loss"]["device_ms"] == pytest.approx(60 * NS)
    assert table["rt/forward"]["device_ms"] == pytest.approx(30 * NS)
    assert table["rt/forward"]["device_ms_inclusive"] == pytest.approx(
        90 * NS)
    assert table["rt/step"]["device_ms_inclusive"] == pytest.approx(
        235 * NS)
    assert table["rt/remat_replay"]["launches"] == 2
    # idle time splits where the host's innermost span changes: the
    # forward's [100, 120), [150, 300) and [390, 400); the loss's
    # [300, 320) and [380, 390)
    assert table["rt/forward"]["idle_ms"] == pytest.approx(180 * NS)
    assert table["rt/loss"]["idle_ms"] == pytest.approx(30 * NS)
    # every idle ns of the window goes to exactly one row
    assert sum(r["idle_ms"] for r in table.values()) == pytest.approx(
        (tr.window_s - tr.busy_s) * 1e3)
    assert sum(r["launches"] for r in table.values()) == len(tr.launches)
    rep = spantrace.report(tr, devtrace.read(profile_of(
        BENCH + SPANS + WORK)))
    assert rep["optimizer_span_ms_per_step"] == pytest.approx(
        rep["optimizer_range_ms_per_step"])


@pytest.mark.parametrize("name", ["train-rwkv6-1.6b", "train-internvl2-1b"])
def test_a_traced_run_of_the_program_has_its_spans(name, monkeypatch):
    cell = tiny_cell(name)
    got = []
    read = devtrace.read

    def both(prof):
        got.append(spantrace.read(prof))
        return read(prof)
    monkeypatch.setattr(devtrace, "read", both)
    res = harness.run(cell.name, 2**31 + 17, 0.05, True, "cpu",
                      time.perf_counter(), cell=cell)
    assert res["correct"], res["checks"]
    tr = got[0]
    steps = cell.traffic["traced_steps"]
    assert tr.steps() == steps
    names = [n for _, _, n in tr.spans]
    for n in ("rt/forward", "rt/backward", "rt/optimizer", "rt/head",
              "rt/loss", "rt/backward/head_loss", "rt/embed"):
        assert names.count(n) == steps + 1, n   # and the profiler's first
    n_layers = cell.config["program"]["overrides"]["n_layers"]
    assert names.count("rt/layer") == names.count("rt/remat_replay") \
        == n_layers * (steps + 1)

"""``correct`` on tiny float32 versions of the cells: a sound run is
correct under the cells' limits; the same run with the timed path broken
underneath (each fault a training cell can have) is not, nor is the
control (the reference with its products in float8 in the program's
place).  One chip at one cell's size: the exchange between chips does not
exist here."""
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_cell
from portbench.traffic import make_ring

CELLS = ["train-rwkv6-1.6b", "train-internvl2-1b"]


def _run(name, fault=None, seed=2**31 + 11):
    cell = tiny_cell(name)
    return harness.run(name, seed, 0.05, False, "cpu", time.perf_counter(),
                       fault=fault, cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_reads_the_window_untraced():
    """A traced run keeps its window's host-clock numbers apart from the
    profiled steps: mfu comes from the untraced window, the profiled
    steps are counted as attempted, and the run is still correct."""
    cell = tiny_cell("train-rwkv6-1.6b")
    res = harness.run(cell.name, 2**31 + 13, 0.05, True, "cpu",
                      time.perf_counter(), cell=cell)
    assert res["correct"], res["checks"]
    assert res["metrics"]["mfu"]["unit"] == "%"
    assert res["metrics"]["mfu"]["value"] > 0
    assert res["attempted"] >= 1 + 1 + cell.traffic["traced_steps"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", harness.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    seed = 2**31 + 29
    ring = make_ring(cell.traffic, cell.model, seed, "cpu")[:3]
    ref = harness.reference_readings(cell, seed, ring, "cpu")
    ctl = harness.reference_readings(cell, seed, ring, "cpu", "fp8")
    ok, checks = harness.judge(harness.gaps(ctl, ref), cell.limits)
    assert not ok, checks


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    """The control at internvl2-1b's own size on the card, one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell("train-internvl2-1b")
    seed = 2**31 + 31
    ring = make_ring(cell.traffic, cell.model, seed, "cuda")[:3]
    ref = harness.reference_readings(cell, seed, ring, "cuda")
    ctl = harness.reference_readings(cell, seed, ring, "cuda", "fp8")
    ok, checks = harness.judge(harness.gaps(ctl, ref), cell.limits)
    assert not ok, checks

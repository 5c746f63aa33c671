"""The ``train-qwen1.5-moe-a2.7b`` cell on the CPU: a tiny float32 version
of it is correct under the cell's limits, and each planted fault and the
control are not; ``flops_moe``'s counts at the cell's own shape; the two
readers that are new with it (``mfu_moe``, ``moe_gmm_roofline``) on a
synthetic trace; and its reference imports nothing of the program."""
import copy
import time

import pytest
import torch

from portbench import devtrace, flops, flops_moe, harness
from portbench.tests.test_portbench_imports import _modules_after
from portbench.traffic import loss_positions, make_ring
from repro_torch.models import moe as M

CELL = "train-qwen1.5-moe-a2.7b"
MS = 1_000_000      # ns
TINY_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, vocab=512, n_experts=8, top_k=2, moe_d_ff=32,
                  shared_d_ff=96, attention={"layers": 2, "heads": 4,
                                             "kv_heads": 4, "head_dim": 16,
                                             "causal": True})
TINY_PROGRAM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                    d_ff=32, vocab=512, n_experts=8, top_k=2,
                    shared_expert_ff=96)


def tiny() -> harness.Cell:
    cell = harness.load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(copy.deepcopy(TINY_MODEL))
    cfg["dtype"] = "float32"
    cfg["program"]["overrides"] = dict(cfg["program"]["overrides"],
                                       dtype="float32", **TINY_PROGRAM)
    cfg["program"]["agrees"] = {}
    traffic = dict(copy.deepcopy(cell.traffic), batch=2, seq=16, ring=4)
    return harness.Cell(name=cell.name, entry=cell.entry, config=cfg,
                        traffic=traffic, limits=dict(cell.limits))


def _run(fault=None, seed=2**31 + 11):
    return harness.run(CELL, seed, 0.05, False, "cpu", time.perf_counter(),
                       fault=fault, cell=tiny())


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_tokens_per_s", "peak_mem_gb",
                                   "setup_s"}
    assert res["failed"] == 0


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_fault_is_not_correct(fault):
    res = _run(fault)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    cell = tiny()
    seed = 2**31 + 29
    ring = make_ring(cell.traffic, cell.model, seed, "cpu")[:3]
    ref = harness.reference_readings(cell, seed, ring, "cpu")
    ctl = harness.reference_readings(cell, seed, ring, "cpu", "fp8")
    ok, checks = harness.judge(harness.gaps(ctl, ref), cell.limits)
    assert not ok, checks


def test_traced_run_reads_the_new_metrics():
    cell = tiny()
    res = harness.run(CELL, 2**31 + 13, 0.05, True, "cpu",
                      time.perf_counter(), cell=cell)
    assert res["correct"], res["checks"]
    # the CPU route launches no moe_gmm kernel: its roofline is left out
    assert res["metrics"]["mfu_moe"]["value"] > 0
    assert "moe_gmm_roofline" not in res["metrics"]
    assert "mfu" not in res["metrics"]


def test_model_flops_at_the_cells_shape():
    cell = harness.load_cell(CELL)
    m = cell.model
    shapes = cell.reference.expected_shapes(m)
    d, f, fs, e = 2048, 1408, 5632, 15
    attn = 4 * d * d
    dense = attn + 3 * d * fs + d * 60 + d      # + the router, the gate
    experts = e * 3 * d * f
    assert flops.product_weights(shapes, 12, m["product_weights"]) \
        == 12 * dense
    assert flops.product_weights(shapes, 12, m["expert_weights"]) \
        == 12 * experts
    n = 4 * 4096
    want = (6.0 * 12 * (dense + experts * 4 / 60) * n
            + 6.0 * d * 151936 * loss_positions(cell.traffic)
            + 12.0 * 12 * 16 * 128 * 4096 / 2 * n)
    got = flops_moe.model_flops_per_step(m, shapes, 4, 4096,
                                         loss_positions(cell.traffic))
    assert got == pytest.approx(want)
    assert got == pytest.approx(1.11e14, rel=0.01)


def test_grouped_product_counts_at_the_cells_shape():
    m = harness.load_cell(CELL).model
    pairs = flops_moe.expected_pairs(m, 4 * 4096)
    assert pairs == 16384          # 16,384 tokens x 4 choices x 15 / 60
    call = flops_moe.gmm_call(pairs, 2048, 1408, 15)
    assert call["flops"] == 2.0 * 16384 * 2048 * 1408
    assert call["bytes"] == 2.0 * (16384 * 2048 + 15 * 2048 * 1408
                                   + 16384 * 1408)
    # operations bound it: 95.5 us against 59.6 us of bytes
    assert flops_moe.gmm_bound_s(call) == pytest.approx(
        call["flops"] / 989e12)
    assert flops_moe.gmm_bound_s(call) > call["bytes"] / 3.35e12


def ctx(ops, steps=2, window_steps=10, window_s=5.0):
    tr = devtrace.Trace(ops=ops, window=(0, 100 * MS), ranges=[])
    return harness.MetricContext(cell=harness.load_cell(CELL), trace=tr,
                                 steps=steps, window_steps=window_steps,
                                 window_s=window_s)


def op(name, start_ms, dur_ms):
    return devtrace.DeviceOp(name, int(start_ms * MS),
                             int((start_ms + dur_ms) * MS), "forward+loss")


def profiled(pairs):
    """The program's record of profiled forwards' counts, as a traced run
    of the cell leaves it: one [kept, largest, dropped] a layer-step."""
    M.take_counts()
    M._RECORD.extend((lambda: None, torch.tensor([p, p, 0])) for p in pairs)


def test_readers_on_a_synthetic_trace():
    bound = flops_moe.gmm_bound_s(flops_moe.gmm_call(16384, 2048, 1408, 15))
    # four launches at twice their bound, two kinds of kernel, and a
    # cuBLAS product that is not counted
    ops = [op("moe_gmm_kernel", 0, 2e3 * bound),
           op("moe_gmm_kernel", 1, 2e3 * bound),
           op("moe_gmm_dw_kernel", 2, 2e3 * bound),
           op("moe_gmm_dw_kernel", 3, 2e3 * bound),
           op("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 4, 1.0)]
    c = ctx(ops)
    read = lambda name: harness.metric_reader(name).read(c)
    # 2 steps of 12 layers, each at 16,384 pairs; a left-out first
    # profiled step before them is not counted
    profiled([1] * 12 + [16384] * 24)
    assert read("moe_gmm_roofline") == pytest.approx(50.0, rel=1e-4)
    assert M.take_counts() == []
    # the counts, not an expectation: at a quarter of the pairs the
    # launches' bound is the larger of a quarter of the operations and
    # the weights' bytes
    quarter = flops_moe.gmm_bound_s(flops_moe.gmm_call(4096, 2048, 1408, 15))
    profiled([4096] * 24)
    assert read("moe_gmm_roofline") == pytest.approx(
        100.0 * quarter / (2 * bound), rel=1e-4)
    assert quarter > bound / 4
    # no record, or too short a one: nothing to read
    assert read("moe_gmm_roofline") is None
    profiled([16384] * 23)
    assert read("moe_gmm_roofline") is None
    # the grouped kernels are not counted as cuBLAS products
    assert read("matmul_ms_per_step") == pytest.approx(0.5)
    cell = c.cell
    per_step = flops_moe.model_flops_per_step(
        cell.model, cell.reference.expected_shapes(cell.model), 4, 4096,
        loss_positions(cell.traffic))
    assert read("mfu_moe") == pytest.approx(
        100.0 * 10 * per_step / 5.0 / 989e12)
    # nothing to read: no grouped kernel, or a cell without experts
    profiled([16384] * 24)
    assert harness.metric_reader("moe_gmm_roofline").read(ctx(ops[4:])) \
        is None
    other = harness.MetricContext(
        cell=harness.load_cell("train-internvl2-1b"), trace=c.trace,
        steps=2, window_steps=10, window_s=5.0)
    assert harness.metric_reader("mfu_moe").read(other) is None
    assert harness.metric_reader("moe_gmm_roofline").read(other) is None


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("import portbench.reference.moe, "
                          "portbench.flops_moe")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}

"""Each per-layer metric's reader on a small synthetic trace, and the
trace reader on synthetic profiler events."""
import types

import pytest
import torch

from portbench import devtrace, flops, harness

MS = 1_000_000      # ns


def op(name, start_ms, dur_ms, launched_in="backward and glue"):
    return devtrace.DeviceOp(name, int(start_ms * MS),
                             int((start_ms + dur_ms) * MS), launched_in)


def ctx(cell_name, ops, window_ms=100.0, steps=2, window_steps=10,
        window_s=1.0):
    tr = devtrace.Trace(ops=ops, window=(0, int(window_ms * MS)), ranges=[])
    return harness.MetricContext(cell=harness.load_cell(cell_name),
                                 trace=tr, steps=steps,
                                 window_steps=window_steps,
                                 window_s=window_s)


def read(metric, c):
    return harness.metric_reader(metric).read(c)


def test_idle_share_and_busy_union():
    c = ctx("train-rwkv6-1.6b", [op("a", 0, 10), op("b", 5, 10),
                                 op("c", 50, 10), op("d", 95, 10)])
    # busy [0, 15) + [50, 60) + [95, 100), clipped to the window: 30 ms
    # over 2 traced steps; an untraced step takes 1.0 s / 10 steps = 100 ms
    assert c.trace.busy_s == pytest.approx(0.030)
    assert read("device_idle_share", c) == pytest.approx(85.0)
    # the profiler's host cost lengthens the traced window, not the share
    # (busy [0, 15) + [50, 60) = 25 ms over 2 steps in either window)
    inside = c.trace.ops[:3]
    for window_ms in (100.0, 400.0):
        c = ctx("train-rwkv6-1.6b", inside, window_ms=window_ms)
        assert read("device_idle_share", c) == pytest.approx(87.5)


def test_matmul_ms_per_step_by_name():
    ops = [op("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", 0, 4),
           op("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm>", 4, 6),
           op("sm90_xmma_gemm_bf16bf16_bf16f32", 10, 2),
           op("void wkv6_kernel<64>(CUtensorMap_st)", 12, 5),
           op("void at::native::elementwise_kernel<128, 2>", 17, 3)]
    assert read("matmul_ms_per_step", ctx("train-rwkv6-1.6b", ops)) \
        == pytest.approx((4 + 6 + 2) / 2)


def test_optimizer_ms_per_step_by_launch_range():
    ops = [op("mul", 0, 3, "optimizer"), op("add", 3, 1, "optimizer"),
           op("mm", 4, 9, "forward+loss")]
    assert read("optimizer_ms_per_step", ctx("train-rwkv6-1.6b", ops)) \
        == pytest.approx(2.0)
    unlinked = [op("mul", 0, 3, None)]
    assert read("optimizer_ms_per_step",
                ctx("train-rwkv6-1.6b", unlinked)) is None


def test_k3_roofline():
    fb, bb = flops.k3_bounds(flops.k3_call(4, 32, 4096, 64))
    ops = [op("void wkv6_kernel<64>(CUtensorMap_st)", 0, 0.4),
           op("void wkv6_kernel<64>(CUtensorMap_st)", 1, 0.4),
           op("void wkv6_bwd_kernel<64>(CUtensorMap_st)", 2, 2.5)]
    got = read("k3_roofline", ctx("train-rwkv6-1.6b", ops))
    assert got == pytest.approx(100 * (2 * fb + bb) / 3.3e-3)
    assert 0 < got <= 100
    # the other cell runs no K3: nothing to read
    assert read("k3_roofline", ctx("train-internvl2-1b", [])) is None


def test_k2_roofline():
    fb, bb = flops.k2_bounds(flops.k2_call(4, 14, 2, 4352, 64, True))
    ops = [op("void flash_wgmma_kernel<64, true>(CUtensorMap_st)", 0, 0.5),
           op("void flash_wgmma_kernel<64, true>(CUtensorMap_st)", 1, 0.5),
           op("void fa_bwd_wgmma::fa_bwd_dot<64>(bf16 const*)", 2, 0.1),
           op("void fa_bwd_wgmma::fa_bwd_dkdv_wgmma<64, false>(x)", 3, 1.0),
           op("void fa_bwd_wgmma::fa_bwd_dq_wgmma<64, false>(x)", 5, 0.6)]
    got = read("k2_roofline", ctx("train-internvl2-1b", ops))
    assert got == pytest.approx(100 * (2 * fb + bb) / 2.7e-3)
    assert read("k2_roofline", ctx("train-rwkv6-1.6b", [])) is None


def test_mfu_over_the_untraced_window():
    c = ctx("train-internvl2-1b", [op("x", 0, 1)], window_ms=9000.0,
            steps=3, window_steps=90, window_s=51.0)
    cell = c.cell
    per_step = flops.model_flops_per_step(
        cell.model, cell.reference.expected_shapes(cell.model), 4, 4352,
        4 * 4095)
    assert read("mfu", c) == pytest.approx(100 * 90 * per_step / 51.0
                                           / 989e12)
    # about 11% at 90 steps in 51 s
    assert 10 < read("mfu", c) < 12
    assert read("mfu", ctx("train-internvl2-1b", [], window_steps=0)) \
        is None


class FakeEvent:
    def __init__(self, name, device, start, dur, corr, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_trace_read_links_launches_and_drops_range_echoes():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [FakeEvent("window", cpu, 0, 100, 1),
              FakeEvent("window", gpu, 0, 100, 1),       # the range's echo
              FakeEvent("optimizer", cpu, 50, 20, 2),
              FakeEvent("optimizer", gpu, 50, 20, 2),
              FakeEvent("cudaLaunchKernel", cpu, 10, 1, 7),
              FakeEvent("cudaLaunchKernel", cpu, 55, 1, 8),
              FakeEvent("gemm_kernel", gpu, 20, 30, 7, 4),
              FakeEvent("adam_kernel", gpu, 60, 10, 8, 4)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tr = devtrace.read(prof)
    assert tr.window == (0, 100)
    assert [(o.name, o.launched_in) for o in tr.ops] == [
        ("gemm_kernel", devtrace.OTHER), ("adam_kernel", "optimizer")]
    assert tr.busy_s == pytest.approx(40e-9)
    # gaps [0, 20), [50, 60) (the host in the optimizer), [70, 100)
    assert tr.idle_gaps() == [(devtrace.OTHER, 20e-9), ("optimizer", 10e-9),
                              (devtrace.OTHER, 30e-9)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm_kernel", 30e-9]

"""The yardstick's arithmetic at the cells' shapes: the model FLOPs a
position and K2's and K3's operations, bytes and bounds."""
import pytest

from portbench import flops, harness


RWKV_BODY = 24 * 55_443_456
RWKV_HEAD = 2048 * 65536
VLM_BODY = 24 * 14_909_440
VLM_HEAD = 151_655 * 896          # the tied head


@pytest.mark.parametrize("name, body, head, per_step, positions", [
    # rwkv6-1.6b: the layers' products over 4 x 4,096 positions, the head
    # over the 4 x 4,095 that carry a loss
    ("train-rwkv6-1.6b", RWKV_BODY, RWKV_HEAD,
     6.0 * RWKV_BODY * 4 * 4096 + 6.0 * RWKV_HEAD * 4 * 4095, 4096),
    # internvl2-1b: the layers over 4 x 4,352 positions, the patch prefix
    # included; the head over the 4 x 4,095 text positions with a loss;
    # causal attention 12 * 24 * 14 * 64 * 4352 / 2 a position
    ("train-internvl2-1b", VLM_BODY, VLM_HEAD,
     6.0 * VLM_BODY * 4 * 4352 + 6.0 * VLM_HEAD * 4 * 4095
     + 12 * 24 * 14 * 64 * 4352 / 2 * 4 * 4352, 4352),
])
def test_model_flops(name, body, head, per_step, positions):
    cell = harness.load_cell(name)
    shapes = cell.reference.expected_shapes(cell.model)
    assert cell.positions_per_row() == positions
    n = cell.model["n_layers"]
    assert flops.product_weights(shapes, n, cell.model["product_weights"]) \
        == body
    assert flops.product_weights(shapes, n, cell.model["head_weights"]) \
        == head
    assert flops.model_flops_per_step(cell.model, shapes, 4, positions,
                                      4 * 4095) \
        == pytest.approx(per_step, rel=1e-12)


def test_k3_at_the_cell_shape():
    call = flops.k3_call(4, 32, 4096, 64)
    th = 4 * 4096 * 32
    assert call["fwd_flops"] == 5 * 64 * 64 * th
    assert call["bwd_flops"] == 11 * 64 * 64 * th
    x = th * 64 * 4
    assert call["fwd_bytes"] == 5 * x + 32 * 64 * 4
    assert call["bwd_bytes"] == 9 * x + 2 * 32 * 64 * 4
    fwd, bwd = flops.k3_bounds(call)
    # both bytes-bound: 671 MB and 1.21 GB at 3.35 TB/s
    assert fwd == pytest.approx(0.20032741e-3, rel=1e-6)
    assert bwd == pytest.approx(0.36058983e-3, rel=1e-6)


def test_k2_at_the_cell_shape():
    s = 4352
    call = flops.k2_call(4, 14, 2, s, 64, True)
    pairs = 4 * 14 * s * (s + 1) // 2
    assert call["fwd_flops"] == 4 * 64 * pairs
    assert call["bwd_flops"] == 8 * 64 * pairs
    fwd, bwd = flops.k2_bounds(call)
    # both compute-bound at 989 TFLOP/s
    assert fwd == pytest.approx(call["fwd_flops"] / 989e12)
    assert bwd == pytest.approx(call["bwd_flops"] / 989e12)
    assert fwd == pytest.approx(0.13730276e-3, rel=1e-6)


def test_k2_pairs():
    causal = flops.k2_call(1, 1, 1, 4, 64, True)
    full = flops.k2_call(1, 1, 1, 4, 64, False)
    assert causal["fwd_flops"] == 4 * 64 * 10
    assert full["fwd_flops"] == 4 * 64 * 16

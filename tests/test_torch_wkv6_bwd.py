"""PyTorch port, K3's backward: the CUDA kernel's order of work
(``ref.wkv6_bwd_blocked``: checkpoints every 16 steps, two register
sub-chunks of 8 recomputed from each, u's terms folded into a_t and c_t,
the lanes' and the cluster's sums in the kernel's order) against
``jax.grad`` of the reference's WKV6 oracle, jitted, around the checkpoint
interval, at every head size and with decays in [0, 0.05) that include
exact zeros.  The kernel itself against the plain version is in
test_torch_cuda.py.

Tolerance: 1e-4 · max(1, max|g|) absolute, the gradient leaves' criterion
of test_torch_train_grad.py: f32 sums in other orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ref import wkv6_ref as j_ref
from repro_torch.kernels import tma_able
from repro_torch.kernels.rwkv_scan.kernel import wkv6_bwd_scratch_bytes
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
from repro_torch.kernels.rwkv_scan.ref import (BWD_CHUNK_STEPS,
                                               wkv6_bwd_blocked,
                                               wkv6_bwd_ref)

_GRAD = jax.jit(jax.grad(lambda r, k, v, w, u, do: jnp.sum(
    j_ref(r, k, v, w, u) * do), argnums=(0, 1, 2, 3, 4)))


def inputs(seed, b, h, t, n, small_w):
    """r, k, v, dO normal, u normal, w in [0.45, 0.95) or, with
    ``small_w``, in [0, 0.05) with a tenth of it exactly 0."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((b, h, t, n)).astype(np.float32)
                   for _ in range(4))
    if small_w:
        w = (rng.random((b, h, t, n)) * 0.05).astype(np.float32)
        w[rng.random(w.shape) < 0.1] = 0.0
    else:
        w = (rng.random((b, h, t, n)) * 0.5 + 0.45).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u, do


# (B, H, T, N, small w): T around the 16-step interval and its 8-step
# halves, each head size past two intervals, and the small decays
CASES = [(2, 3, 1, 64, False), (1, 2, 15, 64, False),
         (2, 2, 16, 64, False), (1, 3, 17, 64, False),
         (2, 1, 33, 64, False), (1, 2, 67, 64, False),
         (2, 3, 40, 16, False), (1, 2, 37, 32, False),
         (2, 2, 45, 64, True)]


@pytest.mark.parametrize("b,h,t,n,small_w", CASES)
def test_blocked_order_matches_jax_grad(b, h, t, n, small_w):
    arrays = inputs(b * 1000 + t * 10 + n, b, h, t, n, small_w)
    want = _GRAD(*arrays)
    got = wkv6_bwd_blocked(*(torch.from_numpy(a) for a in arrays))
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        x = np.asarray(x)
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape, name
        tol = 1e-4 * max(1.0, float(np.abs(x).max()))
        np.testing.assert_allclose(g.numpy(), x, atol=tol, rtol=0, err_msg=name)


def test_small_decays_stay_finite_and_match_the_plain_version():
    """At w = 0 the state forgets at once: every gradient is finite and the
    plain version's autograd agrees (no division by w anywhere)."""
    arrays = inputs(7, 1, 2, 2 * BWD_CHUNK_STEPS + 3, 32, True)
    assert (arrays[3] == 0).any()
    ts = [torch.from_numpy(a) for a in arrays]
    got = wkv6_bwd_blocked(*ts)
    want = wkv6_bwd_ref(*ts)
    for g, x in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(
            g, x, atol=1e-4 * max(1.0, float(x.abs().max())), rtol=0)


def test_tma_able_takes_what_the_backward_kernel_reads():
    x = torch.zeros((2, 40, 3, 16))
    assert tma_able(x) and tma_able(x.transpose(1, 2))
    # an expanded gradient (stride 0), an odd stride, a shifted base
    assert not tma_able(torch.ones(()).expand(2, 40, 3, 16))
    assert not tma_able(torch.zeros((2, 40, 3, 17))[..., :16])
    assert not tma_able(torch.zeros(2 * 40 * 3 * 16 + 1)[1:].view(2, 40, 3, 16))


def test_model_layout_backward_takes_an_expanded_gradient():
    """``sum().backward()`` hands WKV6 an expanded dO, which the kernel's
    TMA cannot read: the backward copies it and gives the gradients of
    an explicit all-ones dO."""
    arrays = inputs(3, 2, 2, 20, 16, False)[:5]
    leaves = [torch.from_numpy(a).transpose(1, 2).contiguous()
              .requires_grad_(True) for a in arrays[:4]]
    leaves.append(torch.from_numpy(arrays[4]).requires_grad_(True))
    wkv6_seq(*leaves).sum().backward()
    want = wkv6_bwd_ref(*(torch.from_numpy(a) for a in arrays),
                        torch.ones((2, 2, 20, 16)))
    for x, w in zip(leaves[:4], want[:4]):
        torch.testing.assert_close(x.grad.transpose(1, 2), w, atol=0, rtol=0)
    torch.testing.assert_close(leaves[4].grad, want[4], atol=0, rtol=0)


def test_scratch_is_the_checkpoints_alone():
    """rwkv6-1.6b's training shape: 127 checkpoints of 64 x 64 f32 a
    (b, h) and du's [B, H, N] partials, no dv partials."""
    assert wkv6_bwd_scratch_bytes(4, 32, 2048, 64) == \
        4 * (4 * 32 * 127 * 64 * 64 + 4 * 32 * 64) == 266_371_072
    assert wkv6_bwd_scratch_bytes(1, 1, 16, 64) == 4 * 64

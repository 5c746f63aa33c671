"""PyTorch port, WKV6 kernel: the plain version and the wrapper on CPU
tensors against the reference's jnp oracle on the reference kernel test's
shapes, the reference's Pallas kernel (interpret mode) on one shape, a
ragged sequence length, and the model-layout wrapper; the CUDA kernel
against the plain version is in test_torch_cuda.py.

Tolerances: 1e-4 in f32 and 0.15 in bf16 inputs (the output is f32), the
reference kernel test's (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.kernel import wkv6 as j_wkv6
from repro.kernels.rwkv_scan.ref import wkv6_ref as j_ref
from repro_torch.kernels.rwkv_scan.kernel import wkv6
from repro_torch.kernels.rwkv_scan.ops import wkv6_seq
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref

# the reference kernel test's shapes (tests/test_kernels.py)
SHAPES = [(2, 3, 256, 32, "float32"),
          (1, 2, 128, 64, "float32"),
          (2, 1, 512, 16, "float32"),
          (1, 2, 128, 64, "bfloat16")]
RAGGED = [(2, 3, 77, 32, "float32"), (1, 2, 33, 64, "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 0.15}


def make_inputs(seed, b, h, t, n, dtype):
    """The reference kernel test's generator: r/k/v normal, w in
    [0.45, 0.95), u normal; as JAX and torch arrays of the same values."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal((b, h, t, n)) for _ in range(3)]
    host.append(rng.random((b, h, t, n)) * 0.5 + 0.45)
    host.append(rng.standard_normal((h, n)))
    host = [a.astype(np.float32) for a in host]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in host]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in host]
    return jx, tx


def close(got, want, dtype):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,h,t,n,dtype", SHAPES + RAGGED)
def test_plain_version_matches_reference_oracle(b, h, t, n, dtype):
    jx, tx = make_inputs(b * t + n, b, h, t, n, dtype)
    got = wkv6_ref(*tx)
    close(got, j_ref(*jx), dtype)
    # the wrapper on CPU tensors runs the plain version
    assert torch.equal(wkv6(*tx), got)


def test_plain_version_matches_pallas_kernel():
    jx, tx = make_inputs(5, 1, 2, 128, 64, "float32")
    close(wkv6(*tx), j_wkv6(*jx, bt=64, interpret=True), "float32")


@pytest.mark.parametrize("t", [64, 45])
def test_model_layout_wrapper(t):
    """wkv6_seq takes [B,T,H,N] and writes its f32 output in that layout."""
    jx, tx = make_inputs(t, 2, 3, t, 16, "float32")
    tm = [x.transpose(1, 2).contiguous() for x in tx[:4]]
    got = wkv6_seq(*tm, tx[4])
    assert got.shape == tm[0].shape and got.is_contiguous()
    close(got.transpose(1, 2), j_ref(*jx), "float32")


@pytest.mark.parametrize("break_arg", ["dtype", "head_size", "u", "strides",
                                       "out"])
def test_wrapper_refuses_what_the_kernel_does_not_take(break_arg):
    _, (r, k, v, w, u) = make_inputs(0, 1, 2, 16, 16, "float32")
    out = None
    if break_arg == "dtype":
        w = w.double()
    elif break_arg == "head_size":
        _, (r, k, v, w, u) = make_inputs(0, 1, 2, 16, 24, "float32")
    elif break_arg == "u":
        u = u[:1]
    elif break_arg == "strides":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        out = torch.empty(r.shape, dtype=torch.bfloat16)
    n0 = wkv6.launches
    with pytest.raises((TypeError, ValueError)):
        wkv6(r, k, v, w, u, out=out)
    assert wkv6.launches == n0

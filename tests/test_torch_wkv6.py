"""PyTorch port, WKV6 kernel: the plain version and the wrapper on CPU
tensors against the reference's jnp oracle on the reference kernel test's
shapes, the reference's Pallas kernel (interpret mode) on one shape, a
ragged sequence length, and the model-layout wrapper; the CUDA kernel's
folded arithmetic against the oracle; the TMA checks on its layouts.  The CUDA
kernel against the plain version is in test_torch_cuda.py.

Tolerances: 1e-4 in f32 and 0.15 in bf16 inputs (the output is f32), the
reference kernel test's (tests/test_kernels.py); 1e-5 for the folded
arithmetic, which runs in f32 on the same upcast values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.kernel import wkv6 as j_wkv6
from repro.kernels.rwkv_scan.ref import wkv6_ref as j_ref
from repro_torch.kernels import check_tma
from repro_torch.kernels.rwkv_scan.kernel import _strides, wkv6
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


def folded_wkv6(r, k, v, w, u):
    """The CUDA kernel's arithmetic, step by step: u's term folded into one
    scalar a step, o_t = r_t S_{t-1} + v_t c_t with c_t = sum r_t u k_t,
    and S_t = w_t * S_{t-1} + k_t^T v_t (in f32)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    b, h, t, n = r.shape
    s = torch.zeros((b, h, n, n))
    out = torch.empty((b, h, t, n))
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i] for x in (r, k, v, w))
        c = (rt * u.float() * kt).sum(-1, keepdim=True)
        out[:, :, i] = torch.einsum("bhn,bhnm->bhm", rt, s) + vt * c
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return out


@pytest.mark.parametrize("b,h,t,n,dtype", SHAPES)
def test_folded_arithmetic_matches_reference_oracle(b, h, t, n, dtype):
    jx, tx = make_inputs(b * t + n + 1, b, h, t, n, dtype)
    np.testing.assert_allclose(folded_wkv6(*tx).numpy(),
                               np.asarray(j_ref(*jx)), atol=1e-5, rtol=1e-5)


def test_tma_checks_take_the_layouts_the_kernel_is_given():
    """The kernel layout and the forward's transposed [B,T,H,N] views pass
    the TMA checks, in both dtypes, and so does an f32 output in either
    layout; an f32 output whose rows are not 16-byte multiples raises
    (before any launch, so nothing falls back)."""
    for dtype in ("float32", "bfloat16"):
        _, (r, k, v, w, u) = make_inputs(0, 2, 4, 8, 16, dtype)
        model = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in (r, k, v, w)]
        check_tma(zip("rkvw", (r, k, v, w)))
        check_tma(zip("rkvw", model))
    out = torch.empty((2, 8, 4, 16)).transpose(1, 2)
    check_tma([("out", out), ("out", out.contiguous())])
    with pytest.raises(ValueError, match="stride"):
        check_tma([("out", torch.zeros((2, 4, 8, 18))[..., :16])])


def test_strides_of_length_one_dims_are_replaced():
    """A dim of length 1 is never stepped along; its stride becomes one
    that TMA takes, the others are passed as they are."""
    x = torch.zeros((1, 4, 1, 64))
    assert _strides(x) == [64, 64, 64]
    y = torch.zeros((2, 5, 3, 64)).transpose(1, 2)
    assert _strides(y) == [y.stride(0), y.stride(1), y.stride(2)]

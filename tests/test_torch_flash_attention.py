"""PyTorch port, flash-attention kernel: the plain version and the wrapper on
CPU tensors against the reference's jnp oracle on the reference kernel
test's shapes, the reference's Pallas kernel (interpret mode) on one shape,
a ragged sequence length, and the model-layout wrapper; the CUDA kernel
against the plain version is in test_torch_cuda.py.

Tolerances: 2e-5 in f32 and 3e-2 in bf16, the reference kernel test's
(tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ops import flash_sdpa as j_flash_sdpa
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.kernels.flash_attention.ref import attention_ref

# the reference kernel test's shapes (tests/test_kernels.py)
SHAPES = [(2, 4, 2, 256, 64, True, "float32"),
          (1, 8, 8, 128, 128, False, "float32"),
          (2, 2, 1, 512, 32, True, "float32"),
          (1, 4, 4, 256, 64, True, "bfloat16"),
          (3, 6, 2, 128, 64, False, "float32")]
RAGGED = [(2, 4, 2, 77, 64, True, "float32"),
          (1, 6, 3, 130, 16, False, "bfloat16")]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def make_inputs(seed, b, h, kv, s, hd, dtype):
    """Seeded q [B,H,S,hd], k/v [B,KV,S,hd] as JAX and torch arrays of the
    same values."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in host]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in host]
    return jx, tx


def close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,h,kv,s,hd,causal,dtype", SHAPES + RAGGED)
def test_plain_version_matches_reference_oracle(b, h, kv, s, hd, causal,
                                                dtype):
    jx, tx = make_inputs(b * s + hd, b, h, kv, s, hd, dtype)
    want = j_ref(*jx, causal=causal)
    got = attention_ref(*tx, causal=causal)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, dtype)
    # the wrapper on CPU tensors runs the plain version
    assert torch.equal(flash_attention(*tx, causal=causal), got)


def test_plain_version_matches_pallas_kernel():
    b, h, kv, s, hd = 3, 6, 2, 128, 64
    jx, tx = make_inputs(3, b, h, kv, s, hd, "float32")
    for causal in (True, False):
        want = j_flash(*jx, causal=causal, bq=64, bk=64, interpret=True)
        close(flash_attention(*tx, causal=causal), want, "float32")


@pytest.mark.parametrize("s", [128, 77])
def test_model_layout_wrapper(s):
    """flash_sdpa takes [B,S,H,hd] and writes its output in that layout."""
    jx, tx = make_inputs(s, 2, 4, 2, s, 32, "float32")
    jm = [jnp.swapaxes(a, 1, 2) for a in jx]
    tm = [t.transpose(1, 2).contiguous() for t in tx]
    got = flash_sdpa(*tm, causal=True)
    assert got.shape == tm[0].shape and got.is_contiguous()
    want = (j_flash_sdpa(*jm, causal=True, interpret=True) if s % 64 == 0
            else jnp.swapaxes(j_ref(*jx, causal=True), 1, 2))
    close(got, want, "float32")


@pytest.mark.parametrize("break_arg", ["dtype", "head_dim", "heads",
                                       "contiguity", "out"])
def test_wrapper_refuses_what_the_kernel_does_not_take(break_arg):
    _, (q, k, v) = make_inputs(0, 1, 4, 2, 64, 32, "float32")
    out = None
    if break_arg == "dtype":
        k = k.to(torch.bfloat16)
    elif break_arg == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif break_arg == "heads":
        _, (q, k, v) = make_inputs(0, 1, 4, 3, 64, 32, "float32")
    elif break_arg == "contiguity":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        out = torch.empty((1, 4, 64, 32), dtype=torch.bfloat16)
    n0 = flash_attention.launches
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, out=out)
    assert flash_attention.launches == n0

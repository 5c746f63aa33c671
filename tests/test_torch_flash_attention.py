"""PyTorch port, flash-attention kernel: the plain version and the wrapper on
CPU tensors against the reference's jnp oracle on the reference kernel
test's shapes, the reference's Pallas kernel (interpret mode) on one shape,
a ragged sequence length, and the model-layout wrapper; the sliding window
and the query offset against the reference's ``_sdpa_naive`` and
``_sdpa_chunked``; the CUDA kernel against the plain version is in
test_torch_cuda.py.

Tolerances: 2e-5 in f32 and 3e-2 in bf16, the reference kernel test's
(tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ops import flash_sdpa as j_flash_sdpa
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models.attention import _sdpa_chunked, _sdpa_naive
from repro_torch.kernels import check_tma
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        WGMMA_HEAD_DIMS,
                                                        _route, _strides,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ops import flash_sdpa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import _sdpa_train

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


@pytest.mark.parametrize("window", [0, 1, 8, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_route_depends_on_dtype_head_dim_and_window(dtype, hd, window):
    """bf16 at hd 64 and 128 without a window takes the wgmma kernel; f32
    at every head dim (it must stay within 2e-5, which TF32 tensor cores
    cannot give), bf16 at 16, 32 and 256, and every windowed call take the
    FMA kernel."""
    want = ("wgmma" if dtype == "bfloat16" and hd in (64, 128) and not window
            else "fma")
    assert _route(getattr(torch, dtype), hd, window) == want


# (B, H, KV, Sq, Sk, hd, causal, window): recurrentgemma's MQA at hd 256
# (reduced), a window that clips, one at least S (no clip), window 1 (each
# row sees itself), Sq > Sk with rows that see no key (they average every
# key, as the reference's softmax over NEG_INF does), full attention with
# a window over Sq < Sk, full attention with a window, and cross-shaped
# Sq != Sk
WINDOWED = [(2, 4, 1, 40, 40, 256, True, 8),
            (1, 4, 2, 96, 96, 64, True, 16),
            (1, 4, 2, 40, 40, 32, True, 64),
            (2, 2, 1, 33, 33, 16, True, 1),
            (1, 4, 2, 56, 24, 128, True, 10),
            (1, 4, 2, 24, 56, 64, False, 10),
            (1, 2, 2, 48, 48, 16, False, 5),
            (1, 4, 4, 30, 70, 64, False, 0)]


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window", WINDOWED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_matches_the_reference(b, h, kv, sq, sk, hd, causal, window,
                                      dtype):
    """attention_ref and the wrapper (model layout, CPU) against the
    reference's _sdpa_naive, and _sdpa_chunked where Sk splits into
    chunks, with the same window."""
    rng = np.random.default_rng(sq * sk + hd + window)
    host = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    jm = [jnp.asarray(a, getattr(jnp, dtype)) for a in host]
    tm = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in host]
    kw = dict(causal=causal, window=window)
    got = flash_sdpa(*tm, **kw)
    assert got.dtype == getattr(torch, dtype)
    close(got, _sdpa_naive(*jm, **kw), dtype)
    kernel_layout = [t.transpose(1, 2) for t in tm]
    assert torch.equal(attention_ref(*kernel_layout, **kw).transpose(1, 2),
                       got)
    if sk % 8 == 0:
        close(got, _sdpa_chunked(*jm, chunk=8, **kw), dtype)


def test_head_dim_256_takes_the_fma_route_alone():
    """The wgmma kernel is built for hd 64 and 128: hd 256 is an FMA
    head dim, and a head dim neither route is built for is refused
    before any launch."""
    assert 256 in HEAD_DIMS and 256 not in WGMMA_HEAD_DIMS
    assert _route(torch.bfloat16, 256) == "fma"
    _, (q, k, v) = make_inputs(0, 1, 4, 2, 64, 64, "bfloat16")
    wide = [torch.cat([t] * 8, dim=-1) for t in (q, k, v)]    # hd 512
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*wide)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    assert flash_attention.launches == n0


def test_model_attention_refuses_a_query_offset():
    """K2 takes no query offset (no model calls one), so the model's
    full-sequence attention refuses a non-zero one before any launch
    instead of ignoring it."""
    _, (q, k, v) = make_inputs(0, 1, 4, 2, 64, 32, "float32")
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="q_offset"):
        _sdpa_train(q, k, v, causal=True, q_offset=3)
    assert flash_attention.launches == n0
    assert torch.equal(_sdpa_train(q, k, v, causal=True, q_offset=0),
                       flash_sdpa(q, k, v, causal=True))


def test_wrapper_on_cpu_counts_no_launch():
    """CPU tensors run the plain version on either route's inputs."""
    before = (flash_attention.launches, flash_attention.launches_wgmma,
              flash_attention.launches_fma)
    for dtype in ("bfloat16", "float32"):
        _, tx = make_inputs(5, 1, 4, 2, 64, 64, dtype)
        flash_attention(*tx)
    assert (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fma) == before


def test_tma_checks_refuse_what_the_wgmma_route_cannot_read():
    """The wgmma route's TMA needs 16-byte aligned bases and strides: the
    model layout passes, an odd sequence stride or a shifted base raises
    (before any launch, so nothing falls back)."""
    _, (q, k, v) = make_inputs(0, 2, 4, 2, 64, 64, "bfloat16")
    model = q.transpose(1, 2).contiguous().transpose(1, 2)
    check_tma([("q", q), ("k", k), ("v", v), ("q_model", model)])
    wide = torch.zeros((2, 4, 64, 65), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="stride"):
        check_tma([("q", wide)])
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        check_tma([("q", shifted.view(q.shape))])


def test_strides_of_length_one_dims_are_replaced():
    """A dim of length 1 is never stepped along; its stride becomes one
    that TMA takes, the others are passed as they are."""
    t = torch.zeros((1, 4, 1, 64))[:, :, :, :]
    assert _strides(t) == [64, 64, 64]
    u = torch.zeros((2, 3, 5, 64)).transpose(1, 2)
    assert _strides(u) == [u.stride(0), u.stride(2), u.stride(1)]
